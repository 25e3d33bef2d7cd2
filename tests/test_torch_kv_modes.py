"""Lean KV-cache modes of the port against the JAX package, fp32, tiny
sizes: scaled-int8 and fp8 storage (``quantize_kv`` and the fp8 cast bit for
bit), the widened ``decode_attend_appended`` (K2's plain version: scale
folding, fp8, a sliding window, an attend bound below the length; atol 1e-5 /
rtol 1e-4), the decoder's prefill and decode steps on int8 and fp8 caches,
the ring-slot arithmetic, and the entry points' default device."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import LlamaConfig
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu.models import llama as jllama
from dynamic_llava_tpu.ops import attention as jattn
from dynamic_llava_tpu.ops import kv_cache as jkv
from dynamic_llava_tpu_torch import weights as tweights
from dynamic_llava_tpu_torch.models import dynamic as tdyn
from dynamic_llava_tpu_torch.models import llama as tllama
from dynamic_llava_tpu_torch.ops import attention as tattn
from dynamic_llava_tpu_torch.ops import kv_cache as tkv
from dynamic_llava_tpu_torch.ops import quant as tquant
from dynamic_llava_tpu_torch.ops.decode_attention import decode_attention

from test_torch_config import port_config

ATOL, RTOL = 1e-5, 1e-4
FP8 = torch.float8_e4m3fn
STORES = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, FP8)}


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _bytes(a) -> np.ndarray:
    """The raw bytes of a one-byte array of either package."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _bf16(x: np.ndarray):
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()


# --- quantize_kv and the fp8 cast, bit for bit --------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    """int8 values and bf16 scales, with an all-zero vector (scale floor
    1e-8 / 127), a vector of one huge value, and exact ties (k + 0.5 steps)."""
    x = _np((3, 5, 4, 16), 0)
    x[0, 0, 0] = 0.0
    x[0, 0, 1] = 0.0
    x[0, 0, 1, 3] = 3e4
    x[0, 0, 2] = np.arange(16, dtype=np.float32) * 0.5 - 4.0  # ties at amax 127 * k
    x[0, 0, 2, 0] = 127.0
    jx, tx = (jnp.asarray(x), torch.from_numpy(x)) if dtype == "float32" else _bf16(x)
    jq, js = jkv.quantize_kv(jx)
    tq, ts = tkv.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(), np.asarray(js).view(np.int16))
    np.testing.assert_array_equal(
        tkv.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jkv.dequantize_kv(jq, js, jnp.float32)))


def _fp8_grid() -> np.ndarray:
    """fp32 values around everything the e4m3 cast decides: every finite
    bf16 value up to 2^10 in magnitude, the midpoints between neighbouring
    fp8 values (ties) and their fp32 neighbours, subnormals, +-448 and what
    lies past it, and random normals."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    bf = bits.view(np.float32)
    bf = bf[np.isfinite(bf) & (np.abs(bf) <= 1024.0)]
    fp8 = np.asarray(jnp.asarray(np.arange(256, dtype=np.uint8)).view(jnp.float8_e4m3fn)
                     .astype(jnp.float32))
    pos = np.sort(fp8[np.isfinite(fp8) & (fp8 >= 0)])
    mid = ((pos[1:] + pos[:-1]) / 2).astype(np.float32)
    ties = np.concatenate([mid, np.nextafter(mid, np.float32(0)),
                           np.nextafter(mid, np.float32(1e9))])
    edge = np.array([448.0, 463.99, 464.0, 464.01, 479.0, 480.0, 512.0, 1e6, np.inf,
                     2.0 ** -9, 2.0 ** -10, 2.0 ** -11, 1e-8, 0.0], np.float32)
    rnd = _np((4096,), 1, 3.0)
    half = np.concatenate([bf, ties, edge, rnd])
    return np.concatenate([half, -half]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_cast_byte_equal_to_jax(dtype):
    """``to_storage(x, float8_e4m3fn)`` against the XLA ``astype``: round to
    nearest even, NaN past +-464 (this PyTorch's own cast saturates to
    +-448 there: ``to_storage`` repairs that)."""
    x = _fp8_grid()
    jx, tx = (jnp.asarray(x), torch.from_numpy(x)) if dtype == "float32" else _bf16(x)
    want = _bytes(jx.astype(jnp.float8_e4m3fn))
    got = _bytes(tkv.to_storage(tx, FP8))
    np.testing.assert_array_equal(got, want)
    assert (want & 0x7F == 0x7F).sum() > 10  # the grid does reach the NaN range
    # the read side: fp8 -> fp32 is exact in both
    back = tkv.to_storage(tx, FP8).float().numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jx.astype(jnp.float8_e4m3fn).astype(jnp.float32)))


def test_fp8_cache_is_written_through_its_bytes():
    """``init_cache`` / ``write_token_layers`` on an fp8 cache (PyTorch has
    no fill and no indexed assignment for fp8: the port goes through a uint8
    view) against JAX ``write_token_layers``."""
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    tcfg = port_config(cfg)
    jc = jkv.init_cache(cfg, 3, 6, jnp.float8_e4m3fn, num_layers=2)
    tc = tkv.init_cache(tcfg, 3, 6, FP8, num_layers=2)
    assert tc.k.dtype == FP8 and not tc.quantized and tc.k_scale is None
    assert not _bytes(tc.k).any()
    k, v = _np((2, 3, 1, 2, 16), 2), _np((2, 3, 1, 2, 16), 3)
    slots = np.tile(np.array([0, 5, 2], np.int32), (2, 1))
    jk, jv = jkv.write_token_layers(jc.k, jc.v, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(slots))
    tkv.write_token_layers(tc.k, tc.v, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(slots))
    np.testing.assert_array_equal(_bytes(tc.k), _bytes(jk))
    np.testing.assert_array_equal(_bytes(tc.v), _bytes(jv))


def test_int8_cache_token_and_scale_writes_match_jax():
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    jc = jkv.init_cache(cfg, 3, 6, jnp.int8, num_layers=2)
    tc = tkv.init_cache(port_config(cfg), 3, 6, torch.int8, num_layers=2)
    assert tc.quantized and tc.k_scale.shape == (2, 3, 6, 2)
    assert tc.k_scale.dtype == torch.bfloat16
    k, v = _np((2, 3, 1, 2, 16), 4), _np((2, 3, 1, 2, 16), 5)
    slots = np.tile(np.array([1, 4, 5], np.int32), (2, 1))
    jqk, jsk = jkv.quantize_kv(jnp.asarray(k))
    jqv, jsv = jkv.quantize_kv(jnp.asarray(v))
    jk, jv = jkv.write_token_layers(jc.k, jc.v, jqk, jqv, jnp.asarray(slots))
    jks, jvs = jkv.write_token_scales(jc.k_scale, jc.v_scale, jsk, jsv, jnp.asarray(slots))
    tqk, tsk = tkv.quantize_kv(torch.from_numpy(k))
    tqv, tsv = tkv.quantize_kv(torch.from_numpy(v))
    tkv.write_token_layers(tc.k, tc.v, tqk, tqv, torch.from_numpy(slots))
    tkv.write_token_scales(tc.k_scale, tc.v_scale, tsk, tsv, torch.from_numpy(slots))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.k_scale.float().numpy(), np.asarray(jks, np.float32))
    np.testing.assert_array_equal(tc.v_scale.float().numpy(), np.asarray(jvs, np.float32))


def test_init_cache_refuses_other_dtypes():
    with pytest.raises(ValueError):
        tkv.init_cache(port_config(LlamaConfig.tiny()), 1, 4, torch.float16)


@pytest.mark.parametrize("use_active", [False, True])
def test_advance_tiered_matches_jax(use_active):
    cfg = LlamaConfig.tiny()
    jc = jkv.init_tiered_cache(cfg, 1, 3, 8, 6, jnp.float32)
    tc = tkv.init_tiered_cache(port_config(cfg), 1, 3, 8, 6, torch.float32)
    keep = np.array([1, 0, 1], np.int32)
    active = np.array([True, True, False]) if use_active else None
    ja = jkv.advance_tiered(jc, jnp.asarray(keep),
                            active=None if active is None else jnp.asarray(active))
    ta = tkv.advance_tiered(tc, torch.from_numpy(keep),
                            active=None if active is None else torch.from_numpy(active))
    np.testing.assert_array_equal(ta.pre.length.numpy(), np.asarray(ja.pre.length))
    np.testing.assert_array_equal(ta.post.length.numpy(), np.asarray(ja.post.length))
    assert ta.pre.length.dtype == torch.int32


# --- the widened decode attention (K2's plain version) ------------------------


def _attend_inputs(store, seed=0, b=3, max_len=12, h=4, hkv=2, d=16):
    """Shared inputs of both packages; ``store`` in int8 / fp8 / own."""
    q, kn, vn = _np((b, 1, h, d), seed), _np((b, 1, hkv, d), seed + 1), \
        _np((b, 1, hkv, d), seed + 2)
    kc, vc = _np((b, max_len, hkv, d), seed + 3), _np((b, max_len, hkv, d), seed + 4)
    jin = dict(q=jnp.asarray(q), k_cur=jnp.asarray(kn), v_cur=jnp.asarray(vn))
    tin = dict(q=torch.from_numpy(q), k_cur=torch.from_numpy(kn), v_cur=torch.from_numpy(vn))
    jkw, tkw = {}, {}
    if store == "int8":
        jin["k_cache"], jkw["k_scale"] = jkv.quantize_kv(jnp.asarray(kc))
        jin["v_cache"], jkw["v_scale"] = jkv.quantize_kv(jnp.asarray(vc))
        tin["k_cache"], tkw["k_scale"] = tkv.quantize_kv(torch.from_numpy(kc))
        tin["v_cache"], tkw["v_scale"] = tkv.quantize_kv(torch.from_numpy(vc))
    elif store == "fp8":
        jin["k_cache"] = jnp.asarray(kc).astype(jnp.float8_e4m3fn)
        jin["v_cache"] = jnp.asarray(vc).astype(jnp.float8_e4m3fn)
        tin["k_cache"] = tkv.to_storage(torch.from_numpy(kc), FP8)
        tin["v_cache"] = tkv.to_storage(torch.from_numpy(vc), FP8)
    else:
        jin["k_cache"], jin["v_cache"] = jnp.asarray(kc), jnp.asarray(vc)
        tin["k_cache"], tin["v_cache"] = torch.from_numpy(kc), torch.from_numpy(vc)
    return jin, tin, jkw, tkw


@pytest.mark.parametrize("window", [None, 5], ids=["no-window", "window5"])
@pytest.mark.parametrize("store", ["int8", "fp8", "own"])
def test_decode_attend_appended_matches_jax(store, window):
    """Lengths 0, a bound below the persisted length (what the ring passes)
    and a full cache; with the window, ``q_pos`` at and past the bound."""
    jin, tin, jkw, tkw = _attend_inputs(store)
    bound = np.array([0, 7, 12], np.int32)
    q_pos = np.array([0, 9, 12], np.int32)
    if window is not None:
        jkw.update(window=window, q_pos=jnp.asarray(q_pos))
        tkw.update(window=window, q_pos=torch.from_numpy(q_pos))
    # under one jit: one compile a form, not one an op
    want = jax.jit(jattn.decode_attend_appended, static_argnames=("window",))(
        jin["q"], jin["k_cache"], jin["v_cache"], jin["k_cur"], jin["v_cur"],
        jnp.asarray(bound), **jkw)
    args = (tin["q"], tin["k_cache"], tin["v_cache"], tin["k_cur"], tin["v_cur"],
            torch.from_numpy(bound))
    got = tattn.decode_attend_appended(*args, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # the kernel's wrapper runs this plain version for CPU tensors
    torch.testing.assert_close(decode_attention(*args, **tkw), got, atol=0, rtol=0)


def test_scale_fold_equals_dequantize_then_attend():
    """Folding the int8 scales into scores and probabilities is the same
    function as attending over the dequantized cache."""
    _, tin, _, tkw = _attend_inputs("int8", seed=10)
    bound = torch.tensor([3, 12, 8], dtype=torch.int32)
    folded = tattn.decode_attend_appended(
        tin["q"], tin["k_cache"], tin["v_cache"], tin["k_cur"], tin["v_cur"], bound, **tkw)
    kd = tkv.dequantize_kv(tin["k_cache"], tkw["k_scale"], torch.float32)
    vd = tkv.dequantize_kv(tin["v_cache"], tkw["v_scale"], torch.float32)
    plain = tattn.decode_attend_appended(tin["q"], kd, vd, tin["k_cur"], tin["v_cur"], bound)
    torch.testing.assert_close(folded, plain, atol=ATOL, rtol=RTOL)


def test_sliding_window_mask_matches_jax():
    q_pos = np.array([[3, 9], [0, 5]], np.int32)
    k_pos = np.arange(10, dtype=np.int32)
    got = tattn.sliding_window_mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos), 4)
    want = jattn.sliding_window_mask(jnp.asarray(q_pos), jnp.asarray(k_pos), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_attention_refuses_a_device_without_a_kernel():
    _, tin, _, tkw = _attend_inputs("int8")
    meta = {k: v.to("meta") for k, v in tin.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(meta["q"], meta["k_cache"], meta["v_cache"], meta["k_cur"],
                         meta["v_cur"], torch.zeros(3, dtype=torch.int32, device="meta"),
                         k_scale=tkw["k_scale"].to("meta"), v_scale=tkw["v_scale"].to("meta"))


# --- the decoder on int8 and fp8 caches ---------------------------------------


@pytest.fixture(scope="module")
def decoder():
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    jp = jax.tree.map(np.asarray, jax.jit(jllama.init_llama_params, static_argnums=(1,))(
        jax.random.key(1), cfg))
    return cfg, jp, tweights.params_from_numpy(jp, "cpu", torch.float32)


@pytest.mark.parametrize("store", ["int8", "fp8"])
def test_decoder_prefill_and_decode_on_lean_caches_match_jax(decoder, store):
    """Prefill layers [1, 4) over a ragged batch and two decode steps. The
    two packages' fp32 K/V differ in the last bits, so a stored byte may
    round the other way: at least 99.5% of the valid bytes are equal and the
    rest differ by one step (int8) or one fp8 neighbour; scales within one
    bf16 ulp; hidden states within 2e-3 (one such byte moves them)."""
    cfg, jp, tp = decoder
    tcfg = port_config(cfg)
    jdt, tdt = STORES[store]
    b, s, lo, hi = 2, 12, 1, 4
    x = _np((b, s, cfg.hidden_size), 2)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    valid = np.array([12, 7], np.int32)
    jc = jkv.init_cache(cfg, b, 16, jdt, num_layers=hi - lo)
    tc = tkv.init_cache(tcfg, b, 16, tdt, num_layers=hi - lo)
    jr = jllama.run_layers_prefill(jp, cfg, jnp.asarray(x), jnp.asarray(pos), jc,
                                   jnp.asarray(valid), lo=lo, hi=hi)
    tr = tllama.run_layers_prefill(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos), tc,
                                   torch.from_numpy(valid), lo=lo, hi=hi)
    jcache, tcache = jr.cache, tr.cache

    def hold_caches(upto):
        for i, n in enumerate(upto):
            for name in ("k", "v"):
                jb = np.asarray(getattr(jcache, name)[:, i, :n])
                tb = getattr(tcache, name)[:, i, :n]
                jf, tf = jb.astype(np.float32), tb.float().numpy()
                same = _bytes(tb) == jb.view(np.uint8)
                assert same.mean() >= 0.995, (store, name, same.mean())
                step = 1.0 if store == "int8" else np.abs(jf) * 0.125 + 2.0 ** -9
                assert (np.abs(tf - jf) <= step).all()
                if store == "int8":
                    js = np.asarray(getattr(jcache, name + "_scale")[:, i, :n], np.float32)
                    ts = getattr(tcache, name + "_scale")[:, i, :n].float().numpy()
                    np.testing.assert_allclose(ts, js, rtol=2.0 ** -7, atol=0)

    for i, n in enumerate(valid):
        np.testing.assert_allclose(tr.x[i, :n].numpy(), np.asarray(jr.x[i, :n]),
                                   atol=ATOL, rtol=RTOL)  # prefill attends unrounded K/V
    hold_caches(valid)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))
    for step in range(2):
        xd = _np((b, 1, cfg.hidden_size), 3 + step)
        posd = (valid + step)[:, None]
        jd = jllama.run_layers_decode(jp, cfg, jnp.asarray(xd), jnp.asarray(posd), jcache,
                                      lo=lo, hi=hi)
        td = tllama.run_layers_decode(tp, tcfg, torch.from_numpy(xd), torch.from_numpy(posd),
                                      tcache, lo=lo, hi=hi)
        np.testing.assert_allclose(td.x.numpy(), np.asarray(jd.x), atol=2e-3, rtol=2e-3)
        jcache = jd.cache._replace(length=jd.cache.length + 1)
        tcache = td.cache._replace(length=td.cache.length + 1)
        hold_caches(valid + step + 1)


def test_decode_write_slot_and_attend_bound_match_jax(decoder):
    """The ring's overrides: the step attends ``[0, bound)`` and writes at
    ``write_slot`` instead of the length (fp32 cache)."""
    cfg, jp, tp = decoder
    tcfg = port_config(cfg)
    b, n_layers, max_len = 2, 2, 8
    k, v = _np((n_layers, b, max_len, 2, 16), 7), _np((n_layers, b, max_len, 2, 16), 8)
    length = np.tile(np.array([7, 9], np.int32), (n_layers, 1))  # one past the budget
    jc = jkv.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), length=jnp.asarray(length))
    tc = tkv.KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
                     length=torch.from_numpy(length))
    xd, posd = _np((b, 1, cfg.hidden_size), 9), np.array([[20], [31]], np.int32)
    bound, slot = np.array([7, 7], np.int32), np.array([7, 4], np.int32)
    jd = jllama.run_layers_decode(jp, cfg, jnp.asarray(xd), jnp.asarray(posd), jc, lo=0,
                                  hi=n_layers, attend_bound=jnp.asarray(bound),
                                  write_slot=jnp.asarray(slot))
    td = tllama.run_layers_decode(tp, tcfg, torch.from_numpy(xd), torch.from_numpy(posd), tc,
                                  lo=0, hi=n_layers, attend_bound=torch.from_numpy(bound),
                                  write_slot=torch.from_numpy(slot))
    np.testing.assert_allclose(td.x.numpy(), np.asarray(jd.x), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(td.cache.k.numpy(), np.asarray(jd.cache.k), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(td.cache.v.numpy(), np.asarray(jd.cache.v), atol=ATOL, rtol=RTOL)
    assert not np.array_equal(td.cache.k[:, 1, 4].numpy(), k[:, 1, 4])  # the slot was written


# --- ring slots ---------------------------------------------------------------


@pytest.mark.parametrize("use_active", [False, True])
@pytest.mark.parametrize("budget", [9, 12, 5])
def test_ring_slots_match_jax(budget, use_active):
    """A grid of lengths below, at and far past the budget, and bases from 0
    to past the budget (cap clamps at 1)."""
    length, base = np.meshgrid(np.arange(0, 40, dtype=np.int32),
                               np.array([0, 3, 8, budget, budget + 2], np.int32))
    length, base = length.ravel(), base.ravel()
    active = (np.arange(length.size) % 3 != 0) if use_active else None
    want = jdyn._ring_slots(jnp.asarray(length), jnp.asarray(base), budget,
                            None if active is None else jnp.asarray(active))
    got = tdyn._ring_slots(torch.from_numpy(length), torch.from_numpy(base), budget,
                           None if active is None else torch.from_numpy(active))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("kw", [
    dict(decode_window=4, ring=True), dict(decode_window=4), dict(ring=True),
    dict(decode_window=100, ring=True, bucket=8),
    dict(decode_window=3, ring=True, all_have_image=False, bound_output_budget=False),
])
def test_gen_cache_sizes_match_jax(kw):
    from dynamic_llava_tpu.config import LlavaConfig
    cfg = LlavaConfig.tiny()
    for prompt_len, max_new in ((27, 12), (64, 300)):
        assert tdyn.gen_cache_sizes(port_config(cfg), prompt_len, max_new, **kw) == \
            jdyn.gen_cache_sizes(cfg, prompt_len, max_new, **kw)


def test_make_gen_cache_passes_the_storage_dtype_through():
    from dynamic_llava_tpu.config import LlavaConfig
    cfg = port_config(LlavaConfig.tiny())
    for dtype in (torch.int8, FP8, torch.bfloat16):
        c = tdyn.make_gen_cache(cfg, 2, 27, 12, dtype, decode_window=4, ring=True,
                                device="cpu")
        assert c.pre.k.dtype == dtype and c.post.v.dtype == dtype
        assert c.pre.quantized == (dtype == torch.int8) == c.post.quantized
        assert (c.pre.max_len, c.post.max_len) == tdyn.gen_cache_sizes(
            cfg, 27, 12, decode_window=4, ring=True)


# --- the entry points' default device -----------------------------------------


def test_resolve_device_defaults_to_the_card():
    """``None`` means the card; here, where there is none, that is an error
    and never a quiet run on the CPU. ``"cpu"`` must be said."""
    assert tweights.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert tweights.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tweights.resolve_device(None)


@pytest.mark.parametrize("maker", ["params_from_numpy", "init_llava_params",
                                   "init_quantized_llama_params"])
def test_param_makers_default_to_the_card(maker, monkeypatch):
    """Each param maker resolves ``device=None`` through ``resolve_device``
    (seen without a card: the resolved device is recorded and the CPU handed
    back, so the maker can finish)."""
    from dynamic_llava_tpu.config import LlavaConfig
    seen = []

    def spy(device=None):
        seen.append(torch.device("cuda" if device is None else device))
        return torch.device("cpu")

    monkeypatch.setattr(tweights, "resolve_device", spy)
    monkeypatch.setattr(tquant, "resolve_device", spy)
    cfg = port_config(LlavaConfig.tiny())
    gen = torch.Generator().manual_seed(0)
    if maker == "params_from_numpy":
        out = tweights.params_from_numpy({"w": np.ones((2, 2), np.float32)})
        assert out["w"].dtype == torch.bfloat16
    elif maker == "init_llava_params":
        tweights.init_llava_params(cfg, gen)
    else:
        tquant.init_quantized_llama_params(cfg.text, gen, bits=4)
    assert seen and seen[0].type == "cuda"
