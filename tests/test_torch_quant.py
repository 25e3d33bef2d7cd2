"""Weight-only int8 / int4 serving in the port against the JAX package.

* host functions: ``pack_int4`` / ``unpack_int4`` and ``quantize_weight``
  bit-identical to JAX, ``quantize_llm_params`` the same tree, and the
  direct-quantized init (with the reference's embed-scale fault recorded);
* the plain versions of K5-K8 (``ops.quant_matmul``) against the Pallas
  kernels run in interpret mode, as tests/test_quant_pack.py runs them;
* the dispatch (``ops.quant.linear``) at prefill row counts against the
  JAX ``matmul_q8`` / ``matmul_q4`` (the XLA path), and the wrappers' CPU
  dispatch and argument checks;
* the decoder (prefill, decode, lm_head) on bridged quantized weights.

Inputs come from numpy with a seed; activations are bf16-representable so
that the Pallas kernels' bf16 rounding of x changes nothing. fp32
comparisons use atol 1e-5 / rtol 1e-4; bf16 outputs are compared to one
bf16 rounding step (rtol 8e-3). The CUDA kernels are held against these
plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import LlamaConfig
from dynamic_llava_tpu.models import llama as jllama
from dynamic_llava_tpu.ops import quant as jq
from dynamic_llava_tpu.ops import quant_matmul as jqm
from dynamic_llava_tpu.ops.kv_cache import init_cache as jinit_cache
from dynamic_llava_tpu_torch.models import llama as tllama
from dynamic_llava_tpu_torch.ops import quant as tq
from dynamic_llava_tpu_torch.ops import quant_matmul as tqm
from dynamic_llava_tpu_torch.ops.kv_cache import init_cache as tinit_cache
from dynamic_llava_tpu_torch.weights import params_from_numpy

from test_torch_config import port_config

ATOL, RTOL = 1e-5, 1e-4
CFG = LlamaConfig.tiny(num_key_value_heads=2)
TCFG = port_config(CFG)  # the port's own dataclass, same field values


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _bf16_values(a):
    """fp32 numpy values that bf16 represents exactly."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# host functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 8), (3, 5, 16)])
def test_pack_unpack_int4_bit_exact_against_jax(shape):
    q = np.random.default_rng(0).integers(-8, 8, shape).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_int4(jnp.asarray(q))))
    assert packed.dtype == torch.int8
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), q)
    p = np.random.default_rng(1).integers(-128, 128, shape).astype(np.int8)
    np.testing.assert_array_equal(tq.unpack_int4(torch.from_numpy(p)).numpy(),
                                  np.asarray(jq.unpack_int4(jnp.asarray(p))))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", [((48, 32), 0), ((40, 64), 1), ((3, 32, 48), 1)])
def test_quantize_weight_bit_identical_to_jax(bits, dtype, shape, axis):
    w = _np(shape, 2, 0.02)
    w[..., 0, :] = 0.0  # an all-zero row: the 1e-8 scale floor
    w.flat[5] = 0.5  # an outlier
    jw = jnp.asarray(w, dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    want = jq.quantize_weight(jw, axis=axis, bits=bits)
    got = tq.quantize_weight(tw, axis=axis, bits=bits)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].dtype == (torch.int8 if key != "s" else tw.dtype)
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(want[key], np.float32), err_msg=key)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_llm_params_same_tree_as_jax(bits):
    jp = jllama.init_llama_params(jax.random.key(3), CFG, jnp.float32)
    want = jq.quantize_llm_params({"llm": jax.tree.map(jnp.array, jp)}, bits=bits)
    tp = {"llm": params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)}
    got = tq.quantize_llm_params(tp, bits=bits)
    assert got is tp  # in place
    jl, tl = dict(_leaves(want)), dict(_leaves(got))
    assert jl.keys() == tl.keys()
    for name in jl:
        np.testing.assert_array_equal(tl[name].numpy(), np.asarray(jl[name]), err_msg=name)


@pytest.mark.parametrize("bits", [8, 4])
def test_init_quantized_params_shapes_and_the_embed_scale_fault(bits):
    """The port's direct-quantized init has the JAX shapes except the
    embed scale, which is per row ``[V, 1]``: JAX gives ``[1, D]``, so the
    JAX ``embed_tokens`` gathers scale rows out of bounds (NaN) for every
    id >= 1 -- a fault of the reference that the port does not copy."""
    tp = tq.init_quantized_llama_params(TCFG, torch.Generator().manual_seed(0), "cpu", bits)
    jp = jq.init_quantized_llama_params(jax.random.key(0), CFG, bits=bits)
    jshapes = {k: tuple(v.shape) for k, v in _leaves(jp)}
    tshapes = {k: tuple(v.shape) for k, v in _leaves(tp)}
    assert jshapes.pop("/embed/s") == (1, CFG.hidden_size)
    assert tshapes.pop("/embed/s") == (CFG.vocab_size, 1)
    assert jshapes == tshapes
    key = "q4" if bits == 4 else "q"
    vals = tq.unpack_int4(tp["layers"]["gate"][key]) if bits == 4 else tp["layers"]["gate"][key]
    qmax = 7 if bits == 4 else 127
    assert vals.min() == -qmax and vals.max() == qmax
    deq = tq.dequantize_weight(tp["layers"]["gate"], torch.float32)
    assert abs(deq.std().item() - 0.02) < 0.002

    ids = np.arange(CFG.vocab_size, dtype=np.int32)[None]
    emb = tllama.embed_tokens(tp, torch.from_numpy(ids))
    assert emb.shape == (1, CFG.vocab_size, CFG.hidden_size) and torch.isfinite(emb).all()
    jemb = np.asarray(jllama.embed_tokens(jp, jnp.asarray(ids)), np.float32)
    assert np.isfinite(jemb[0, 0]).all() and np.isnan(jemb[0, 1:]).all()


# ---------------------------------------------------------------------------
# plain K5-K8 against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

ROWS = [1, 5, 8, 24, 64]
# (K, out_fp32): out_fp32 runs on fp32 x (bf16-valued), the bf16-out case
# on bf16 x, so each side rounds the same fp32 result to bf16
K_OUT = [(128, False), (256, True)]


def _weights(k, ns, bits, seed):
    leaves = [jq.quantize_weight(jnp.asarray(_np((k, n), seed + i, 0.02)), axis=0, bits=bits)
              for i, n in enumerate(ns)]
    key = "q4" if bits == 4 else "q"
    return ([l[key] for l in leaves], [l["s"] for l in leaves])


def _compare(got, want, out_fp32):
    want = np.asarray(want, np.float32)
    if out_fp32:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    else:
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6, rtol=8e-3)


KERNELS = {
    # name: (bits, output widths, Pallas wrapper, port wrapper)
    "K5_q8": (8, [192], jqm.matmul_q8_pallas, tqm.q8_gemv),
    "K6_q8_group": (8, [128, 64, 256], jqm.matmul_q8_multi_pallas, tqm.q8_gemv_group),
    "K7_q4": (4, [256], jqm.matmul_q4_pallas, tqm.q4_gemv),
    "K8_q4_group": (4, [256, 128], jqm.matmul_q4_multi_pallas, tqm.q4_gemv_group),
}


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("name", list(KERNELS))
def test_plain_gemv_matches_pallas_interpret(name, rows):
    bits, ns, pallas, port = KERNELS[name]
    group = len(ns) > 1
    for k, out_fp32 in K_OUT:
        ws, ss = _weights(k, ns, bits, seed=10 + rows)
        x = _bf16_values(_np((rows, k), rows))
        jx = jnp.asarray(x, jnp.float32 if out_fp32 else jnp.bfloat16)
        tx = torch.from_numpy(x) if out_fp32 else torch.from_numpy(x).bfloat16()
        tw, ts = [_to_torch(w) for w in ws], [_to_torch(s) for s in ss]
        if group:
            want = pallas(jx, tuple(ws), tuple(ss), out_fp32=out_fp32, interpret=True)
            got = port(tx, tw, ts, out_fp32=out_fp32)
        else:
            want = [pallas(jx, ws[0], ss[0], out_fp32=out_fp32, interpret=True)]
            got = [port(tx, tw[0], ts[0], out_fp32=out_fp32)]
        assert len(got) == len(want) == len(ns)
        for g, w, n in zip(got, want, ns):
            assert tuple(g.shape) == (rows, n)
            _compare(g, w, out_fp32)


# ---------------------------------------------------------------------------
# dispatch and wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("out_fp32", [False, True])
def test_linear_at_prefill_rows_matches_jax_xla_path(bits, out_fp32):
    """Past 64 rows ``linear`` dequantizes and multiplies, as the JAX
    ``matmul_q8`` / ``matmul_q4`` do on their XLA path, and launches no
    GEMV."""
    leaf = jq.quantize_weight(jnp.asarray(_np((64, 128), 4, 0.02)), axis=0, bits=bits)
    x = _np((2, 40, 64), 5)
    fn = jq.matmul_q4 if bits == 4 else jq.matmul_q8
    want = fn(jnp.asarray(x), leaf, out_fp32=out_fp32)
    tleaf = {k: _to_torch(v) for k, v in leaf.items()}
    got = tq.linear({"w": tleaf}, "w", torch.from_numpy(x), out_fp32=out_fp32)
    assert got.shape == (2, 40, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_linear_group_at_decode_rows_matches_jax(bits):
    names = ("q", "k", "v")
    leaves = {n: jq.quantize_weight(jnp.asarray(_np((64, 64), i, 0.02)), axis=0, bits=bits)
              for i, n in enumerate(names)}
    x = _bf16_values(_np((3, 1, 64), 6))
    fn = jq.matmul_q4 if bits == 4 else jq.matmul_q8
    tlp = {n: {k: _to_torch(v) for k, v in leaf.items()} for n, leaf in leaves.items()}
    got = tq.linear_group(tlp, names, torch.from_numpy(x))
    for g, n in zip(got, names):
        np.testing.assert_allclose(g.numpy(), np.asarray(fn(jnp.asarray(x), leaves[n])),
                                   atol=ATOL, rtol=RTOL)


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    fns = (tqm.q8_gemv, tqm.q8_gemv_group, tqm.q4_gemv, tqm.q4_gemv_group)
    before = [f.launches for f in fns]
    x = torch.from_numpy(_np((3, 64), 7))
    q = torch.from_numpy(np.random.default_rng(8).integers(-127, 128, (64, 128)).astype(np.int8))
    s = torch.from_numpy(_np((1, 128), 9, 0.01))
    s4 = torch.from_numpy(_np((1, 256), 10, 0.01))
    exact = dict(atol=0, rtol=0)
    torch.testing.assert_close(tqm.q8_gemv(x, q, s), tqm.q8_gemv_plain(x, q, s), **exact)
    torch.testing.assert_close(tqm.q4_gemv(x, q, s4), tqm.q4_gemv_plain(x, q, s4), **exact)
    for got, want in zip(tqm.q8_gemv_group(x, [q, q], [s, s]), (tqm.q8_gemv_plain(x, q, s),) * 2):
        torch.testing.assert_close(got, want, **exact)
    for got, want in zip(tqm.q4_gemv_group(x, [q], [s4], out_fp32=True),
                         (tqm.q4_gemv_plain(x, q, s4, out_fp32=True),)):
        torch.testing.assert_close(got, want, **exact)
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("fn,int4", [(tqm.q8_gemv, False), (tqm.q4_gemv, True)])
def test_wrappers_refuse_a_device_without_a_kernel(fn, int4):
    """Neither a meta tensor nor anything else but a CPU tensor reaches the
    plain version; the argument checks raise before any launch."""
    x = torch.empty(2, 64, device="meta")
    q = torch.empty(64, 64 if int4 else 128, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fn(x, q, torch.empty(1, 128, device="meta"))


# ---------------------------------------------------------------------------
# the decoder on bridged quantized weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[8, 4], ids=["int8", "int4"])
def quantized(request):
    jp = jllama.init_llama_params(jax.random.key(5), CFG, jnp.float32)
    jq.quantize_llm_params({"llm": jp}, bits=request.param)
    jp = jax.tree.map(np.asarray, jp)
    return jp, params_from_numpy(jp, "cpu", torch.float32)


def test_quantized_decoder_matches_jax(quantized):
    """Prefill layers [1, 4) over a ragged batch, one decode step, and the
    fp32 lm_head logits, on valid rows (the port masks padding rows)."""
    jp, tp = quantized
    b, s, lo, hi = 2, 10, 1, 4
    x = _np((b, s, CFG.hidden_size), 11)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    valid = np.array([10, 6], np.int32)
    jc = jinit_cache(CFG, b, 16, jnp.float32, num_layers=hi - lo)
    tc = tinit_cache(TCFG, b, 16, torch.float32, num_layers=hi - lo)
    jr = jllama.run_layers_prefill(jp, CFG, jnp.asarray(x), jnp.asarray(pos), jc,
                                   jnp.asarray(valid), lo=lo, hi=hi)
    tr = tllama.run_layers_prefill(tp, TCFG, torch.from_numpy(x), torch.from_numpy(pos), tc,
                                   torch.from_numpy(valid), lo=lo, hi=hi)
    for i, n in enumerate(valid):
        np.testing.assert_allclose(tr.x[i, :n].numpy(), np.asarray(jr.x[i, :n]),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tr.cache.k[:, i, :n].numpy(),
                                   np.asarray(jr.cache.k[:, i, :n]), atol=ATOL, rtol=RTOL)
    xd = _np((b, 1, CFG.hidden_size), 12)
    jd = jllama.run_layers_decode(jp, CFG, jnp.asarray(xd), jnp.asarray(valid[:, None]),
                                  jr.cache, lo=lo, hi=hi)
    td = tllama.run_layers_decode(tp, TCFG, torch.from_numpy(xd),
                                  torch.from_numpy(valid[:, None]), tr.cache, lo=lo, hi=hi)
    np.testing.assert_allclose(td.x.numpy(), np.asarray(jd.x), atol=ATOL, rtol=RTOL)

    ids = np.random.default_rng(13).integers(0, CFG.vocab_size, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tllama.embed_tokens(tp, torch.from_numpy(ids)).numpy(),
        np.asarray(jllama.embed_tokens(jp, jnp.asarray(ids))), atol=0, rtol=0)
    got = tllama.lm_head(tp, TCFG, td.x)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jllama.lm_head(jp, CFG, jd.x)),
                               atol=ATOL, rtol=RTOL)
