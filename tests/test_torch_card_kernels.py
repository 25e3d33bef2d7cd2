"""Card-side checks of the hand-written kernels: K1 and K3 (the flash forward
and backward, with K3's delta kernel), K2 (decode attention), K4 (policy
attention), K5-K8 (the weight-only GEMVs) and K9 (the fused int4 MLP)
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
