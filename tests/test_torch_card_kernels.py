"""Card-side checks of the hand-written kernels: K1 and K3 (the flash forward
and backward, with K3's delta kernel), K2 (decode attention) and its
M-query form, K4 (policy attention), K5-K8 (the weight-only GEMVs) and K9
(the fused int4 MLP)
against their plain PyTorch versions on the same inputs, at the case
lists ``chip_smoke.py`` phase 3 runs
(``dynamic_llava_tpu_torch/kernel_cases.py``), with the same tolerances and
the same twice-for-equal-bits rule; the GEMV and MLP work-list mirrors
against the library's own arithmetic; and the CLIP tower's gradient on the
card against the CPU's.

It imports torch and the port only, so it also runs where jax is not
installed. Every test needs an NVIDIA GPU and ``nvcc`` (the kernels are
built at first use) and is skipped without them:

    python -m pytest --noconftest tests/test_torch_card_kernels.py
"""

import numpy as np
import pytest
import torch

from dynamic_llava_tpu_torch import kernel_cases as kc
from dynamic_llava_tpu_torch import kernels
from dynamic_llava_tpu_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.card


@pytest.fixture(scope="module", autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU or interpret mode")
    return kernels.load_library()


def _flash_id(case):
    return f"{case.label}-{str(case.dtype)[6:]}"


@pytest.mark.parametrize("case", kc.FLASH_FWD_CASES, ids=_flash_id)
def test_flash_forward_matches_its_plain_version(case):
    kc.check_flash_fwd_case(case)


@pytest.mark.parametrize("case", kc.FLASH_BWD_CASES, ids=_flash_id)
def test_flash_backward_matches_its_plain_version(case):
    kc.check_flash_bwd_case(case)


@pytest.mark.parametrize("case", kc.DECODE_CASES, ids=lambda c: c.label)
def test_decode_attention_matches_its_plain_version(case):
    kc.check_decode_case(case)


@pytest.mark.parametrize("case", kc.EXTEND_CASES, ids=lambda c: c.label)
def test_extend_attention_matches_its_plain_version(case):
    kc.check_extend_case(case)


def test_extend_attention_launches_the_planned_kernel():
    """Every bf16-q case runs ``extend_mma_kernel``, every fp32 one
    ``extend_kernel``, as ``extend_plan`` says: no fallback between them."""
    kc.check_extend_dispatch(kc.EXTEND_CASES)


@pytest.mark.parametrize("case", kc.EXTEND_CASES, ids=lambda c: c.label)
def test_extend_plan_mirrors_the_library(card, case):
    """``decode_attention.extend_plan``'s workspace, which the wrapper
    allocates, is the one the C entry checks for."""
    plan = kc.extend_case_plan(case)
    store = {"int8": 2, "fp8": 3}.get(case.storage, kernels.DTYPE_CODES[case.dtype])
    want = card.lib.extend_attention_workspace_bytes(
        case.b, case.m, case.h, case.hkv, case.d, plan.n_split,
        kernels.DTYPE_CODES[case.dtype], store)
    assert plan.workspace_bytes == want


def _gemv_params():
    for bits in (8, 4):
        for cases, rows_list in ((kc.QUANT_CASES, kc.QUANT_ROWS),
                                 (kc.QUANT_EDGE_CASES, kc.QUANT_EDGE_ROWS)):
            for case in cases:
                for rows in rows_list:
                    yield pytest.param(case, bits, rows, id=f"int{bits}-{case.label}-rows{rows}")


@pytest.mark.parametrize("case,bits,rows", list(_gemv_params()))
def test_quant_gemv_matches_its_plain_version(case, bits, rows):
    kc.check_gemv_case(case, bits, rows)


@pytest.mark.parametrize("case", kc.QUANT_CASES + kc.QUANT_EDGE_CASES, ids=lambda c: c.label)
def test_gemv_plan_mirrors_the_library(card, case):
    """``quant_matmul.gemv_plan`` (which sizes the scratch) agrees with the
    plan the C entry points make, for every row tier."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ns = list(case.ns) + [0] * (3 - len(case.ns))
    for bits in (8, 4):
        for rows in (1, 16, 17, 32, 33, 64):
            want = card.lib.quant_gemv_scratch_bytes(*ns, len(case.ns), rows, case.k, bits == 4)
            assert qm.gemv_plan(rows, case.k, case.ns, bits == 4, sms).scratch_bytes == want


@pytest.mark.parametrize("case", kc.POLICY_CASES + kc.POLICY_EDGE_CASES,
                         ids=lambda c: f"{c.label}-{str(c.dtype)[6:]}")
def test_policy_attention_matches_its_plain_version(case):
    err, rounding = kc.check_policy_case(case)
    if case.dtype == torch.bfloat16 and case.label == "training shape":
        # the error of the output's own bf16 rounding, not of a rounded e
        assert err <= 2 * rounding


def _mlp_params():
    for cases, rows_list in ((kc.MLP_CASES, kc.QUANT_ROWS), (kc.MLP_EDGE_CASES, kc.MLP_EDGE_ROWS)):
        for case in cases:
            for rows in rows_list:
                for fp32 in (False, True):
                    yield pytest.param(case, rows, fp32,
                                       id=f"{case.label}-rows{rows}-{'fp32' if fp32 else 'bf16'}")


@pytest.mark.parametrize("case,rows,fp32", list(_mlp_params()))
def test_q4_mlp_matches_its_plain_version(case, rows, fp32):
    kc.check_mlp_case(case, rows, fp32)


@pytest.mark.parametrize("case", kc.MLP_CASES + kc.MLP_EDGE_CASES, ids=lambda c: c.label)
def test_mlp_plan_mirrors_the_library(card, case):
    """``quant_matmul.mlp_plan`` (which sizes the scratch and the tickets)
    agrees with the plan the C entry point makes, for every row tier."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows in (1, 16, 17, 32, 33, 64):
        want = card.lib.q4_mlp_scratch_bytes(rows, case.k, case.f, case.d)
        assert qm.mlp_plan(rows, case.k, case.f, case.d, sms).scratch_bytes == want


def test_fp32_x_keeps_full_precision():
    """fp32 x takes the FMA kernel: no rounding of x to bf16."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    case = kc.GemvCase("fp32 x", 4096, (4096,), True)
    for bits in (8, 4):
        (weights,), scales = kc.make_gemv_weights(case, bits, "cuda", gen)
        _, kernel, plain = kc.gemv_functions(bits, False)
        x = torch.randn(8, case.k, generator=gen, device="cuda")
        got = kernel(x, weights[0], scales[0], out_fp32=True)
        want = plain(x, weights[0], scales[0], out_fp32=True)
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_clip_tower_gradient_on_the_card_matches_the_cpu():
    """``encode_images(frozen_tower=False)`` differentiates through K1 and K3
    on the card: the gradient with respect to ``patch_embedding`` equals the
    CPU's (plain versions), fp32, atol = rtol = 1e-4."""
    from dynamic_llava_tpu_torch.config import ClipVisionConfig, LlamaConfig, LlavaConfig
    from dynamic_llava_tpu_torch.models.dynamic import encode_images
    from dynamic_llava_tpu_torch.weights import init_llava_params, map_leaves

    # a tower with head_dim 64 (the kernels take 64 and 128), two layers run
    cfg = LlavaConfig(
        text=LlamaConfig.tiny(hidden_size=256, intermediate_size=512),
        vision=ClipVisionConfig.tiny(hidden_size=128, intermediate_size=256,
                                     num_attention_heads=2))
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    pix = torch.from_numpy(rng.standard_normal((2, size, size, 3), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (2, cfg.num_image_tokens, cfg.text.hidden_size), dtype=np.float32))
    cpu = init_llava_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    grads = {}
    for device in ("cpu", "cuda"):
        params = map_leaves(lambda _, t: t.to(device), cpu)
        leaf = params["vision_tower"]["patch_embedding"].clone().requires_grad_(True)
        params["vision_tower"] = dict(params["vision_tower"], patch_embedding=leaf)
        out = encode_images(params, cfg, pix.to(device), frozen_tower=False)
        grads[device] = torch.autograd.grad((out * g.to(device)).sum(), leaf)[0].cpu()
    assert grads["cpu"].abs().max() > 0
    torch.testing.assert_close(grads["cuda"], grads["cpu"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_k3_from_the_saved_pair_is_bit_equal(dtype):
    """F2: under a checkpoint that saves ``flash_forward`` (the ``flash``
    remat policies) the backward takes K1's (out, lse) from the saved set
    and runs K3 on them with q / k / v recomputed: the gradients equal the
    K1 + K3 autograd path's bit for bit, with one K1 launch instead of the
    recompute's two."""
    from functools import partial

    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    from dynamic_llava_tpu_torch.models.llama import REMAT_SAVES
    from dynamic_llava_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, hkv, d = 2, 130, 4, 2, 64
    w = torch.randn(d, d, generator=gen, device="cuda", dtype=dtype) * d**-0.5
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                  for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)))

    def layer(q_, k_, v_):  # a projection before the attention, recomputed
        return fa.flash_attention_vjp(q_ @ w, k_ @ w, v_ @ w)

    def grads(run):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches
        torch.autograd.backward(run(*ins), g)
        rose = (fa.flash_attention.launches - before[0],
                fa.flash_attention_bwd_dq.launches - before[1])
        return [t.grad for t in ins], rose

    want, plain = grads(layer)
    got, saved = grads(lambda *a: checkpoint(
        layer, *a, use_reentrant=False,
        context_fn=partial(create_selective_checkpoint_contexts, list(REMAT_SAVES["flash"]))))
    again, recomputed = grads(lambda *a: checkpoint(layer, *a, use_reentrant=False))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert all(torch.equal(x, y) for x, y in zip(again, want))
    assert plain == saved == (1, 1) and recomputed == (2, 1)


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "int8", "int4"])
def test_lora_decode_graph_matches_the_eager_loop(bits):
    """Adapters (nonzero B) attached to a small model, plain or quantized:
    the captured decode graph (which holds the adapters' products) gives
    the tokens of an eager loop of ``argmax`` + ``decode_step``."""
    from dynamic_llava_tpu_torch.config import (
        IMAGE_TOKEN_INDEX, ClipVisionConfig, LlamaConfig, LlavaConfig, SparseConfig)
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.models.dynamic import decode_step
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
    from dynamic_llava_tpu_torch.ops.quant import quantize_llm_params
    from dynamic_llava_tpu_torch.train.lora import attach_lora, init_lora_params
    from dynamic_llava_tpu_torch.weights import init_llava_params

    cfg = LlavaConfig(
        text=LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                              num_key_value_heads=2),
        vision=ClipVisionConfig.tiny(hidden_size=128, intermediate_size=256,
                                     num_attention_heads=2),
        sparse=SparseConfig(d_model=64, nhead=2, dim_feedforward=128, num_layers=1))
    gen_ = torch.Generator(device="cuda").manual_seed(0)
    params = init_llava_params(cfg, gen_, "cuda", torch.bfloat16)
    if bits:
        quantize_llm_params(params, bits=bits)
    adapters = init_lora_params(cfg.text, gen_, rank=8, alpha=16.0, dtype=torch.bfloat16,
                                device="cuda")
    for ad in adapters.values():
        ad["b"].normal_(0.0, 0.05, generator=gen_)
    params = attach_lora(params, adapters)
    rng = np.random.default_rng(0)
    ids = [np.concatenate([rng.integers(3, 500, 7), [IMAGE_TOKEN_INDEX],
                           rng.integers(3, 500, 9 + i)]) for i in range(3)]
    pix = rng.standard_normal((3, cfg.vision.image_size, cfg.vision.image_size, 3),
                              dtype=np.float32)
    gc = GenerationConfig(max_new_tokens=16, decode_chunk=8, pad_multiple=8, eos_token_id=-1)
    g = Generator(params, cfg, gc)
    got = g.generate(ids, pix)
    assert g.decode_runner.graphed and g.decode_runner.graph is not None
    plan = plan_batch(ids, cfg.num_image_tokens, pad_multiple=gc.pad_multiple)
    with torch.inference_mode():
        state, _ = g.prefill_from_plan(plan, pix, 16)
        want = []
        for _ in range(16):
            tok = torch.argmax(state.last_logits, dim=-1)
            state = decode_step(g.params, g.cfg, tok, state)
            want.append(tok)
    assert np.array_equal(np.asarray(got).T, torch.stack(want).cpu().numpy())
