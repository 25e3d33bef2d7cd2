"""K9, the fused int4 SwiGLU MLP, in the port against the JAX package.

* ``q4_mlp_plain`` (the arithmetic the CUDA kernel repeats) against the
  Pallas kernel ``matmul_q4_mlp_pallas`` run in interpret mode, at the
  shapes of tests/test_quant_pack.py: rows 1 and 24, two stacked layers,
  leading batch dims. bf16 outputs, atol = rtol = 2e-2: the Pallas kernel
  sums K in windows and the plain version at once, so an ``h`` may round to
  the neighbouring bf16 value and the outputs to neighbouring bf16 values
  (measured maximum 9.8e-4, one bf16 step of an output near 1; three of the
  four cases are equal bit for bit).
* the dispatch ``ops.quant.matmul_q4_mlp``: off by default, on with
  ``DYNAMIC_LLAVA_Q4_MLP``, ``None`` for a leaf that is not int4, for
  prefill rows and for inconsistent shapes;
* a decoder layer's ``_mlp`` against the JAX ``matmul_q4_mlp`` dispatch;
* the whole model, port against port (the JAX model cannot reach its
  Pallas MLP kernel on the CPU): per-step logits of the fused path within
  5e-2 of the two-kernel path (K8 + K7; measured 4.6e-4).

The CUDA kernel itself is held against ``q4_mlp_plain`` on the card by
``chip_smoke.py``.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import LlavaConfig
from dynamic_llava_tpu.constants import IMAGE_TOKEN_INDEX
from dynamic_llava_tpu.ops import quant as jq
from dynamic_llava_tpu.ops import quant_matmul as jqm
from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
from dynamic_llava_tpu_torch.models import dynamic as tdyn
from dynamic_llava_tpu_torch.models import llama as tllama
from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
from dynamic_llava_tpu_torch.ops import quant as tq
from dynamic_llava_tpu_torch.ops import quant_matmul as tqm
from dynamic_llava_tpu_torch.weights import init_llava_params

from test_torch_config import port_config

SWITCH = "DYNAMIC_LLAVA_Q4_MLP"
K_DIM, F_DIM = 256, 512


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _leaf(shape, seed, axis):
    """A JAX int4 leaf ``{"q4", "s"}`` of bf16 weights (the contraction axis
    is ``axis``), and its bridged copy."""
    w = jq.quantize_weight(jnp.asarray(_np(shape, seed, 0.05), jnp.bfloat16), axis=axis, bits=4)
    return w, {k: _to_torch(v) for k, v in w.items()}


@pytest.fixture(scope="module")
def stacked():
    """Two stacked layers, as the decoder's ``layers`` leaves."""
    shapes = {"gate": (2, K_DIM, F_DIM), "up": (2, K_DIM, F_DIM), "down": (2, F_DIM, K_DIM)}
    leaves = {n: _leaf(s, 31 + i, axis=1) for i, (n, s) in enumerate(shapes.items())}
    return {n: l[0] for n, l in leaves.items()}, {n: l[1] for n, l in leaves.items()}


@pytest.fixture()
def switched_on():
    """``DYNAMIC_LLAVA_Q4_MLP=1`` (and the JAX int4 kernel switch) for one
    test, the environment restored after it."""
    saved = {k: os.environ.get(k) for k in (SWITCH, "DYNAMIC_LLAVA_Q4_KERNEL")}
    os.environ[SWITCH] = "1"
    os.environ["DYNAMIC_LLAVA_Q4_KERNEL"] = "1"
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _layer(tl, li):
    return [tl[n]["q4"][li] for n in ("gate", "up", "down")] + \
        [tl[n]["s"][li] for n in ("gate", "up", "down")]


@pytest.mark.parametrize("rows", [1, 24])
@pytest.mark.parametrize("li", [0, 1])
def test_q4_mlp_plain_matches_pallas_interpret(stacked, rows, li):
    jl, tl = stacked
    x = _np((rows, K_DIM), 100 + rows)
    want = jqm.matmul_q4_mlp_pallas(
        jnp.asarray(x, jnp.bfloat16), jl["gate"]["q4"], jl["up"]["q4"], jl["down"]["q4"],
        jl["gate"]["s"][li], jl["up"]["s"][li], jl["down"]["s"][li],
        layer=jnp.int32(li), interpret=True)
    got = tqm.q4_mlp_plain(torch.from_numpy(x).bfloat16(), *_layer(tl, li))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (rows, K_DIM)
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    print(f"q4_mlp_plain vs Pallas interpret, rows {rows} layer {li}: max abs err {err:.3e} "
          f"of max |ref| {np.abs(want).max():.3e}")
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


def test_q4_mlp_plain_fp32_out_and_leading_dims(stacked):
    """fp32 x is rounded to bf16 first, as in the Pallas kernel; the fp32
    output differs from it only by the order of the fp32 sums and the rare
    ``h`` that rounds the other way (atol = rtol = 2e-3 here)."""
    jl, tl = stacked
    x = _np((2, 3, K_DIM), 7)
    want = jqm.matmul_q4_mlp_pallas(
        jnp.asarray(x), jl["gate"]["q4"], jl["up"]["q4"], jl["down"]["q4"],
        jl["gate"]["s"][0], jl["up"]["s"][0], jl["down"]["s"][0], out_fp32=True,
        interpret=True)
    got = tqm.q4_mlp_plain(torch.from_numpy(x), *_layer(tl, 0), out_fp32=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, K_DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)
    # the wrapper runs the plain version for a CPU tensor and counts no launch
    before = tqm.q4_mlp.launches
    torch.testing.assert_close(
        tqm.q4_mlp(torch.from_numpy(x), *_layer(tl, 0), out_fp32=True), got, atol=0, rtol=0)
    assert tqm.q4_mlp.launches == before


def test_q4_mlp_plain_is_the_dequantized_mlp(stacked):
    """Against ``silu(x @ G) * (x @ U) @ D`` on dequantized fp32 weights,
    the reference of tests/test_quant_pack.py (atol = rtol = 5e-2)."""
    jl, tl = stacked
    x = torch.from_numpy(_np((24, K_DIM), 8)).bfloat16()
    g, u, d = (tq.dequantize_weight({"q4": tl[n]["q4"][1], "s": tl[n]["s"][1]}, torch.float32)
               for n in ("gate", "up", "down"))
    want = (torch.nn.functional.silu(x.float() @ g) * (x.float() @ u)) @ d
    got = tqm.q4_mlp_plain(x, *_layer(tl, 1))
    torch.testing.assert_close(got.float(), want, atol=5e-2, rtol=5e-2)


def test_q4_mlp_refuses_a_device_without_a_kernel(stacked):
    _, tl = stacked
    args = [t.to("meta") for t in _layer(tl, 0)]
    with pytest.raises(ValueError, match="unsupported device"):
        tqm.q4_mlp(torch.empty(2, K_DIM, device="meta"), *args)


def _lp(seed=5):
    shapes = {"gate": (K_DIM, F_DIM), "up": (K_DIM, F_DIM), "down": (F_DIM, K_DIM)}
    leaves = {n: _leaf(s, seed + i, axis=0) for i, (n, s) in enumerate(shapes.items())}
    return {n: l[0] for n, l in leaves.items()}, {n: l[1] for n, l in leaves.items()}


def test_matmul_q4_mlp_is_off_by_default():
    _, tlp = _lp()
    assert os.environ.get(SWITCH) is None
    assert tq.matmul_q4_mlp(torch.zeros(1, K_DIM, dtype=torch.bfloat16), tlp) is None


def test_matmul_q4_mlp_dispatch_rules(switched_on):
    """The rules of the JAX ``test_q4_mlp_plan_and_dispatch_rules`` (LoRA
    leaves do not exist in the port yet)."""
    jlp, tlp = _lp()
    x = _np((1, K_DIM), 9)
    tx = torch.from_numpy(x).bfloat16()
    got = tq.matmul_q4_mlp(tx, tlp)
    want = jq.matmul_q4_mlp(jnp.asarray(x, jnp.bfloat16), jlp, interpret=True)
    assert got is not None and want is not None
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)
    assert tq.matmul_q4_mlp(tx, tlp, out_fp32=True).dtype == torch.float32
    int8_down = {k: _to_torch(v) for k, v in jq.quantize_weight(
        jnp.asarray(_np((F_DIM, K_DIM), 3, 0.05), jnp.bfloat16), axis=0, bits=8).items()}
    assert tq.matmul_q4_mlp(tx, {**tlp, "down": int8_down}) is None  # a mixed group
    assert tq.matmul_q4_mlp(tx, {**tlp, "up": torch.zeros(K_DIM, F_DIM)}) is None
    assert tq.matmul_q4_mlp(tx.expand(65, K_DIM), tlp) is None  # prefill rows
    assert tq.matmul_q4_mlp(tx.expand(64, K_DIM), tlp) is not None
    short = {k: v[:F_DIM // 2] if k == "q4" else v for k, v in tlp["down"].items()}
    assert tq.matmul_q4_mlp(tx, {**tlp, "down": short}) is None  # F != 2 * half_f
    narrow = {"q4": tlp["up"]["q4"][:, :-8], "s": tlp["up"]["s"][:, :-16]}
    assert tq.matmul_q4_mlp(tx, {**tlp, "up": narrow}) is None
    assert tq.matmul_q4_mlp(torch.zeros(1, K_DIM // 2, dtype=torch.bfloat16), tlp) is None
    for off in ("0", "", "yes"):
        os.environ[SWITCH] = off
        assert tq.matmul_q4_mlp(tx, tlp) is None


def test_decoder_mlp_takes_the_fused_path_and_matches_jax(switched_on, monkeypatch):
    """``models.llama._mlp`` on a fully int4 layer at decode rows, against
    the JAX dispatch with its Pallas kernel in interpret mode; with the
    switch off the same call goes through K8 + K7."""
    jlp, tlp = _lp(seed=20)
    calls = []
    fused = tq.q4_mlp
    monkeypatch.setattr(tq, "q4_mlp", lambda *a, **k: calls.append(1) or fused(*a, **k))
    h = _np((3, 1, K_DIM), 11)
    th = torch.from_numpy(h).bfloat16()
    want = jq.matmul_q4_mlp(jnp.asarray(h, jnp.bfloat16), jlp, interpret=True)
    got = tllama._mlp(tlp, th)
    assert calls == [1] and tuple(got.shape) == (3, 1, K_DIM)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)
    os.environ[SWITCH] = "0"
    two = tllama._mlp(tlp, th)
    assert calls == [1]
    torch.testing.assert_close(two.float(), got.float(), atol=5e-2, rtol=5e-2)
    os.environ[SWITCH] = "1"
    assert tllama._mlp(tlp, torch.from_numpy(_np((1, 65, K_DIM), 12)).bfloat16()).shape == \
        (1, 65, K_DIM)
    assert calls == [1]  # prefill rows: dequantize and multiply


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_fused_mlp_logits_stay_close_to_the_two_kernel_path(mode, switched_on, monkeypatch):
    """Port against port on the tiny model with an int4 decoder: prefill and
    ten teacher-forced decode steps, the logits of every step with the switch
    on within 5e-2 of those with it off; the fused path runs once per layer
    and step (and in this short prompt's prefill, which has decode rows)."""
    from dynamic_llava_tpu.config import DENSE_SPARSE_CONFIG
    jcfg = LlavaConfig.tiny() if mode == "sparse" else LlavaConfig.tiny(
        sparse=DENSE_SPARSE_CONFIG)
    cfg = port_config(jcfg)
    params = init_llava_params(cfg, torch.Generator().manual_seed(3), "cpu", torch.float32)
    tq.quantize_llm_params(params, bits=4)
    rng = np.random.default_rng(0)
    ids = [np.concatenate([rng.integers(3, 500, 4 + i), [IMAGE_TOKEN_INDEX],
                           rng.integers(3, 500, 5)]) for i in range(2)]
    pix = rng.normal(size=(2, 56, 56, 3)).astype(np.float32)
    steps = 10
    calls = []
    fused = tq.q4_mlp
    monkeypatch.setattr(tq, "q4_mlp", lambda *a, **k: calls.append(1) or fused(*a, **k))
    gen = Generator(params, cfg, GenerationConfig(max_new_tokens=steps, cache_dtype="float32"))
    plan = plan_batch(ids, cfg.num_image_tokens)

    def run(switch, tokens=None):
        os.environ[SWITCH] = switch
        with torch.inference_mode():
            state, _ = gen.prefill_from_plan(plan, pix, steps)
            logits, toks = [state.last_logits], []
            for i in range(steps):
                tok = torch.argmax(state.last_logits, -1) if tokens is None else tokens[i]
                state = tdyn.decode_step(params, cfg, tok, state)
                toks.append(tok)
                logits.append(state.last_logits)
        return torch.stack(logits), toks

    off, toks = run("0")
    assert calls == []
    on, _ = run("1", toks)
    # this prompt is short enough for the prefill to have decode rows too
    assert plan.batch * plan.seq_len <= tqm.MAX_ROWS
    assert len(calls) == (steps + 1) * cfg.text.num_hidden_layers
    err = (on - off).abs().max().item()
    print(f"fused vs two-kernel logits, {mode}: max abs diff {err:.3e}")
    assert err <= 5e-2
