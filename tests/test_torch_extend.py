"""The continuation prefill of the port against the JAX package, fp32, tiny
sizes (atol 1e-5 / rtol 1e-4 unless a case says otherwise):

(a) ``extend_attend_appended`` (the plain version of K2's M-query form)
against the JAX function on the same mask: the cache stored in bf16, fp32,
scaled int8 and fp8; 1 and 4 query heads a KV head at head_dim 64 and 128;
M = 1, 7, 9, 40; cache lengths 0, mid-capacity and full in one batch; with
and without ``chunk_attend`` and a sliding window.
(b) ``extend_attention``'s CPU path: its structured arguments (``length``,
``chunk_attend``, ``window`` with ``positions``) give the mask the JAX
``run_layers_extend`` builds (``extend_mask``, equal), and the same output.
(c) ``run_layers_extend`` against the JAX function: hidden states, the
``kept`` counts and the caches below the scratch slot, on fp32, bf16 and
int8 caches, with a capacity clamp that force-drops kept tokens and with
``chunk_attend``.
(d) ``prefill_continue`` against the JAX function on the cases of
``tests/test_multiround.py`` that need no ``forward_nocache_eval``: one
continuation equals one prefill of the whole sequence, the instruct
predictor's prune of the chunk, a ragged batch against each sample alone,
a ragged batch then greedy decode, and an empty chunk as a no-op.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import LlamaConfig, LlavaConfig, SparseConfig
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu.models import llama as jllama
from dynamic_llava_tpu.multimodal.fusion import plan_batch
from dynamic_llava_tpu.ops import attention as jattn
from dynamic_llava_tpu.ops import kv_cache as jkv
from dynamic_llava_tpu_torch import weights as tweights
from dynamic_llava_tpu_torch.models import dynamic as tdyn
from dynamic_llava_tpu_torch.models import llama as tllama
from dynamic_llava_tpu_torch.ops import attention as tattn
from dynamic_llava_tpu_torch.ops import kv_cache as tkv
from dynamic_llava_tpu_torch.ops.decode_attention import extend_attention, extend_mask

from test_torch_config import port_config

ATOL, RTOL = 1e-5, 1e-4
FP8 = torch.float8_e4m3fn


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _store(kind: str, x: np.ndarray):
    """``x`` stored as ``kind`` in both packages: (jax value, jax scale,
    torch value, torch scale); the two hold the same bits."""
    t = torch.from_numpy(x)
    if kind == "fp32":
        return jnp.asarray(x), None, t, None
    if kind == "bf16":
        tb = t.bfloat16()
        return jnp.asarray(tb.float().numpy()).astype(jnp.bfloat16), None, tb, None
    if kind == "fp8":
        tb = tkv.to_storage(t, FP8)
        return jnp.asarray(tb.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)), None, tb, None
    tq, ts = tkv.quantize_kv(t)
    return (jnp.asarray(tq.numpy()), jnp.asarray(ts.float().numpy()).astype(jnp.bfloat16),
            tq, ts)


def jax_extend_mask(length0, max_len, m, chunk_attend=None, window=None, positions=None):
    """The mask of the JAX ``run_layers_extend``, as it builds it."""
    b = length0.shape[0]
    cache_cols = jnp.arange(max_len, dtype=jnp.int32)
    cache_mask = cache_cols[None, :] < jnp.minimum(length0, max_len)[:, None]
    rows = jnp.arange(m, dtype=jnp.int32)
    chunk_mask = rows[None, :, None] >= rows[None, None, :]
    if chunk_attend is not None:
        self_cols = rows[None, :, None] == rows[None, None, :]
        chunk_mask = chunk_mask & (chunk_attend[:, None, :] | self_cols)
        chunk_mask = jnp.broadcast_to(chunk_mask, (b, m, m))
    mask = jnp.concatenate(
        [jnp.broadcast_to(cache_mask[:, None, None, :], (b, 1, m, max_len)),
         jnp.broadcast_to(chunk_mask[:, None], (b, 1, m, m))], axis=-1)
    if window is not None:
        mask = mask & jnp.concatenate(
            [jattn.sliding_window_mask(positions, cache_cols, window),
             jattn.sliding_window_mask(positions, positions, window)], axis=-1)
    return mask


_jextend = jax.jit(jattn.extend_attend_appended)

MAX_LEN = 24
LENGTHS = np.array([0, 11, MAX_LEN], np.int32)  # empty, mid-capacity, full
WINDOW = 6
MASKS = ["causal", "chunk_attend", "window", "chunk_attend+window"]


def _attend_case(store, m, mask_kind, n_rep, d, seed):
    b, hkv = len(LENGTHS), 2
    h = hkv * n_rep
    q = _np((b, m, h, d), seed)
    kn, vn = _np((b, m, hkv, d), seed + 1), _np((b, m, hkv, d), seed + 2)
    jk, jks, tk, tks = _store(store, _np((b, MAX_LEN, hkv, d), seed + 3, 2.0))
    jv, jvs, tv, tvs = _store(store, _np((b, MAX_LEN, hkv, d), seed + 4, 2.0))
    attend = (np.random.default_rng(seed + 5).random((b, m)) < 0.5
              if "chunk_attend" in mask_kind else None)
    window = WINDOW if "window" in mask_kind else None
    positions = (LENGTHS[:, None] + np.arange(m, dtype=np.int32)[None]).astype(np.int32)
    jmask = jax_extend_mask(jnp.asarray(LENGTHS), MAX_LEN, m,
                            None if attend is None else jnp.asarray(attend), window,
                            jnp.asarray(positions))
    want = np.asarray(_jextend(jnp.asarray(q), jk, jv, jnp.asarray(kn), jnp.asarray(vn), jmask,
                               k_scale=jks, v_scale=jvs))
    tq, tkn, tvn = (torch.from_numpy(a) for a in (q, kn, vn))
    got = tattn.extend_attend_appended(tq, tk, tv, tkn, tvn, torch.from_numpy(np.array(jmask)),
                                       k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # the wrapper's CPU path from the structured arguments
    tmask = extend_mask(torch.from_numpy(LENGTHS), MAX_LEN, m,
                        chunk_attend=None if attend is None else torch.from_numpy(attend),
                        window=window, positions=torch.from_numpy(positions))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    wrapped = extend_attention(tq, tk, tv, tkn, tvn, torch.from_numpy(LENGTHS),
                               chunk_attend=None if attend is None else torch.from_numpy(attend),
                               window=window,
                               positions=None if window is None else torch.from_numpy(positions),
                               k_scale=tks, v_scale=tvs)
    assert torch.equal(wrapped, got)
    assert bool(torch.isfinite(got).all())  # the empty cache row too


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("m", [1, 7, 9, 40])
@pytest.mark.parametrize("store", ["bf16", "fp32", "int8", "fp8"])
def test_extend_attend_appended_matches_jax(store, m, mask_kind):
    for n_rep, d in ((1, 64), (4, 128)):
        _attend_case(store, m, mask_kind, n_rep, d, seed=m + 3 * n_rep)


def test_extend_mask_clamps_the_length_like_jax():
    """A bound past the capacity attends the whole cache, as the JAX clamp
    does (a wrapped ring cache fed to the continuation directly)."""
    length = np.array([MAX_LEN + 5, 3], np.int32)
    got = extend_mask(torch.from_numpy(length), MAX_LEN, 4)
    want = jax_extend_mask(jnp.asarray(length), MAX_LEN, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0, 0, :MAX_LEN].all()


def test_extend_attention_checks_its_arguments():
    q = torch.zeros(1, 2, 2, 64)
    kc = torch.zeros(1, 8, 2, 64, dtype=torch.int8)
    kn = torch.zeros(1, 2, 2, 64)
    length = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        extend_attention(q, kc, kc, kn, kn, length)
    with pytest.raises(ValueError, match="window"):
        extend_attention(q, kc.float(), kc.float(), kn, kn, length, window=4)
    meta = {n: t.to("meta") for n, t in dict(q=q, kc=kc.float(), kn=kn, length=length).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        extend_attention(meta["q"], meta["kc"], meta["kc"], meta["kn"], meta["kn"],
                         meta["length"])


# --- run_layers_extend --------------------------------------------------------


@pytest.fixture(scope="module")
def decoder():
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    jp = jax.tree.map(np.asarray, jax.jit(jllama.init_llama_params, static_argnums=(1,))(
        jax.random.key(3), cfg))
    return cfg, jp, tweights.params_from_numpy(jp, "cpu", torch.float32)


STORES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _raw(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _hold_cache(store, jc, tc, upto):
    """Slots below ``upto`` of both caches: fp32 equal within the
    tolerance; bf16 and int8 hold the same bytes but for stored values whose
    fp32 K/V differ in the last bits between the packages and round the
    other way (at most 0.5% of them, by one step; scales within one bf16
    ulp)."""
    for name in ("k", "v"):
        jb = np.asarray(getattr(jc, name))[:, :, :upto]
        tb = getattr(tc, name)[:, :, :upto]
        jf, tf = jb.astype(np.float32), tb.float().numpy()
        if store == "fp32":
            np.testing.assert_allclose(tf, jf, atol=ATOL, rtol=RTOL)
            continue
        same = (_raw(tb) == _raw(jb)).reshape(jf.shape + (-1,)).all(-1)
        assert same.mean() >= 0.995, (store, name, same.mean())
        step = 1.0 if store == "int8" else np.abs(jf) * 2.0 ** -7 + 1e-30
        assert (np.abs(tf - jf) <= step).all(), (store, name)
        if store == "int8":
            js = np.asarray(getattr(jc, name + "_scale")[:, :, :upto], np.float32)
            ts = getattr(tc, name + "_scale")[:, :, :upto].float().numpy()
            np.testing.assert_allclose(ts, js, rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("chunk_attend", [False, True], ids=["causal", "chunk_attend"])
@pytest.mark.parametrize("store", list(STORES))
def test_run_layers_extend_matches_jax(decoder, store, chunk_attend):
    """Layers [1, 4) over caches filled with the same values, three samples:
    one with room, one whose kept tokens pass the remaining capacity (the
    clamp force-drops them: ``kept`` stops at the room), one full."""
    cfg, jp, tp = decoder
    tcfg = port_config(cfg)
    jdt, tdt = STORES[store]
    b, m, lo, hi, max_len = 3, 9, 1, 4, 20
    n_layers = hi - lo
    jc = jkv.init_cache(cfg, b, max_len, jdt, num_layers=n_layers)
    tc = tkv.init_cache(tcfg, b, max_len, tdt, num_layers=n_layers)
    (jk, jks, tk, tks), (jv, jvs, tv, tvs) = (_store(store, _np(jc.k.shape, 10 + i, 1.5))
                                              for i in range(2))
    length0 = np.array([4, 15, max_len - 1], np.int32)
    lengths = np.tile(length0, (n_layers, 1))
    jc = jc._replace(k=jk, v=jv, length=jnp.asarray(lengths),
                     **({"k_scale": jks, "v_scale": jvs} if store == "int8" else {}))
    tk, tv = tk.clone(), tv.clone()
    tc = tc._replace(k=tk, v=tv, length=torch.from_numpy(lengths),
                     **({"k_scale": tks.clone(), "v_scale": tvs.clone()}
                        if store == "int8" else {}))
    x = _np((b, m, cfg.hidden_size), 20)
    pos = (length0[:, None] + np.arange(m, dtype=np.int32)[None]).astype(np.int32)
    rng = np.random.default_rng(21)
    keep = rng.random((b, m)) < 0.7
    attend = rng.random((b, m)) < 0.5 if chunk_attend else None
    jr = jllama.run_layers_extend(
        jp, cfg, jnp.asarray(x), jnp.asarray(pos), jc, lo=lo, hi=hi, keep=jnp.asarray(keep),
        chunk_attend=None if attend is None else jnp.asarray(attend))
    tr = tllama.run_layers_extend(
        tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos), tc, lo=lo, hi=hi,
        keep=torch.from_numpy(keep),
        chunk_attend=None if attend is None else torch.from_numpy(attend))
    np.testing.assert_array_equal(tr.kept.numpy(), np.asarray(jr.kept))
    room = max_len - 1 - length0
    assert tr.kept.tolist() == np.minimum(keep.sum(1), room).tolist()
    assert tr.kept[1] < keep[1].sum() and tr.kept[2] == 0  # the clamp dropped kept tokens
    # the same stored cache and the chunk's unrounded K/V: fp32 tolerance
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=ATOL, rtol=RTOL)
    assert tr.cache.k is tk  # written in place
    np.testing.assert_array_equal(tr.cache.length.numpy(), lengths)  # not advanced
    _hold_cache(store, jr.cache, tr.cache, max_len - 1)


def test_run_layers_extend_with_no_layers_keeps_nothing(decoder):
    cfg, _, tp = decoder
    tc = tkv.init_cache(port_config(cfg), 2, 8, torch.float32, num_layers=0)
    x = torch.ones(2, 3, cfg.hidden_size)
    r = tllama.run_layers_extend(tp, port_config(cfg), x, torch.zeros(2, 3, dtype=torch.int32),
                                 tc, lo=2, hi=2)
    assert r.x is x and r.kept.tolist() == [0, 0]


def test_write_chunk_layers_matches_jax_scatter():
    """The scatter alone on an fp8 cache (through its bytes): kept tokens at
    their targets, dropped ones at the scratch slot, which is not compared."""
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    jc = jkv.init_cache(cfg, 2, 8, jnp.float8_e4m3fn, num_layers=2)
    tc = tkv.init_cache(port_config(cfg), 2, 8, FP8, num_layers=2)
    kn, vn = _np((2, 2, 3, 2, 16), 30), _np((2, 2, 3, 2, 16), 31)
    target = np.array([[2, 7, 3], [7, 0, 1]], np.int32)
    bidx = jnp.arange(2)[:, None]
    jk = jc.k.at[:, bidx, target].set(jnp.asarray(kn).astype(jnp.float8_e4m3fn))
    jv = jc.v.at[:, bidx, target].set(jnp.asarray(vn).astype(jnp.float8_e4m3fn))
    tkv.write_chunk_layers(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                           torch.from_numpy(target))
    np.testing.assert_array_equal(_raw(tc.k)[:, :, :7], _raw(jk)[:, :, :7])
    np.testing.assert_array_equal(_raw(tc.v)[:, :, :7], _raw(jv)[:, :, :7])


# --- prefill_continue: the cases of tests/test_multiround.py -----------------


def _cfg(**sparse_overrides):
    sparse = SparseConfig(
        d_model=32, nhead=2, dim_feedforward=64, num_layers=1,
        use_vision_predictor=False, use_text_predictor=False,
        use_output_text_predictor=False, use_instruct_predictor=False,
    )
    return LlavaConfig.tiny(sparse=dataclasses.replace(sparse, **sparse_overrides))


_jinit = jax.jit(jdyn.init_llava_params, static_argnums=(1,))
_jcontinue = jax.jit(jdyn.prefill_continue, static_argnums=(1,))
_jdecode = jax.jit(jdyn.decode_step, static_argnums=(1,))


class Both:
    """One config's weights in both packages, with prefill / continue /
    decode on each; states compared by ``same``."""

    def __init__(self, cfg, seed, cache="fp32"):
        self.jcfg, self.tcfg = cfg, port_config(cfg)
        self.jp = _jinit(jax.random.key(seed), cfg)
        self.tp = tweights.params_from_numpy(jax.tree.map(np.asarray, self.jp), "cpu",
                                             torch.float32)
        self.jdt, self.tdt = {"fp32": (jnp.float32, torch.float32),
                              "int8": (jnp.int8, torch.int8)}[cache]

    def prefill(self, rows, pre=64, post=64):
        plan = plan_batch(list(rows), 0)
        arrays = (plan.token_ids, plan.is_image, plan.image_slot, plan.valid_len,
                  plan.spans.image_start, plan.spans.last_instruct_start,
                  plan.spans.last_instruct_end, plan.spans.has_image)
        sl = self.jcfg.sparse.sparse_layer
        jc = jkv.init_tiered_cache(self.jcfg.text, sl, plan.batch, pre, post, self.jdt)
        tc = tkv.init_tiered_cache(self.tcfg.text, sl, plan.batch, pre, post, self.tdt)
        js, _ = jdyn.prefill(self.jp, self.jcfg, *map(jnp.asarray, arrays), None, jc)
        tarr = [torch.from_numpy(np.asarray(a)) for a in arrays]
        for i in (0, 2, 3, 4, 5, 6):
            tarr[i] = tarr[i].to(torch.int32)
        ts, _ = tdyn.prefill(self.tp, self.tcfg, *tarr, None, tc)
        return js, ts

    def cont(self, states, chunk, chunk_len=None):
        js, ts = states
        cl = None if chunk_len is None else np.asarray(chunk_len, np.int32)
        js = _jcontinue(self.jp, self.jcfg, jnp.asarray(chunk), js,
                        None if cl is None else jnp.asarray(cl))
        ts = tdyn.prefill_continue(self.tp, self.tcfg, torch.from_numpy(np.asarray(chunk)), ts,
                                   None if cl is None else torch.from_numpy(cl))
        return js, ts

    def decode(self, states):
        js, ts = states
        jtok = jnp.argmax(js.last_logits, axis=-1)
        ttok = torch.argmax(ts.last_logits, dim=-1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        return (_jdecode(self.jp, self.jcfg, jtok, js),
                tdyn.decode_step(self.tp, self.tcfg, ttok, ts)), ttok.tolist()


def same(states, rows=None, atol=ATOL, rtol=RTOL):
    """Lengths, positions and (the given rows') logits of the two states."""
    js, ts = states
    for tier in ("pre", "post"):
        np.testing.assert_array_equal(getattr(ts.cache, tier).length.numpy(),
                                      np.asarray(getattr(js.cache, tier).length))
    np.testing.assert_array_equal(ts.next_pos.numpy(), np.asarray(js.next_pos))
    rows = slice(None) if rows is None else rows
    np.testing.assert_allclose(ts.last_logits.numpy()[rows], np.asarray(js.last_logits)[rows],
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_prefill_continue_matches_single_prefill(cache):
    """Dense: prefill(A) + continue(B) equals prefill(A + B) (fp32 cache;
    atol 2e-4 / rtol 2e-3 as in the JAX test), and equals the JAX
    continuation, then one decode step too."""
    both = Both(_cfg(), 0, cache)
    rng = np.random.default_rng(0)
    vocab = both.jcfg.text.vocab_size
    a = rng.integers(3, vocab, size=(2, 9))
    bchunk = rng.integers(3, vocab, size=(2, 5))
    states = both.cont(both.prefill(a), bchunk)
    tol = {} if cache == "fp32" else dict(atol=2e-3, rtol=2e-3)
    same(states, **tol)
    ts = states[1]
    assert (ts.cache.pre.length == 14).all() and (ts.next_pos == 14).all()
    if cache == "fp32":
        _, ref = both.prefill(np.concatenate([a, bchunk], axis=1))
        np.testing.assert_allclose(ts.last_logits.numpy(), ref.last_logits.numpy(),
                                   atol=2e-4, rtol=2e-3)
    states, _ = both.decode(states)
    same(states, **tol)


def test_prefill_continue_instruct_pruning():
    """With the instruct predictor, the post tier persists only the kept
    chunk tokens (the last always); both packages keep the same ones."""
    both = Both(_cfg(use_instruct_predictor=True), 1)
    rng = np.random.default_rng(1)
    vocab = both.jcfg.text.vocab_size
    states = both.prefill(rng.integers(3, vocab, size=(1, 8)))
    post0 = int(states[1].cache.post.length[0, 0])
    states = both.cont(states, rng.integers(3, vocab, size=(1, 6)))
    same(states)
    ts = states[1]
    assert int(ts.cache.pre.length[0, 0]) == 8 + 6
    assert post0 + 1 <= int(ts.cache.post.length[0, 0]) <= post0 + 6


def test_prefill_continue_ragged_matches_per_sample():
    """A ragged batch (chunks of 7 and 3, right-padded) gives each sample
    what running it alone gives, and what JAX gives."""
    both = Both(_cfg(), 1)
    rng = np.random.default_rng(2)
    vocab = both.jcfg.text.vocab_size
    a = rng.integers(3, vocab, size=(2, 9))
    chunks = [rng.integers(3, vocab, size=(7,)), rng.integers(3, vocab, size=(3,))]
    padded = np.zeros((2, 7), np.int64)
    padded[0], padded[1, :3] = chunks
    ragged = both.cont(both.prefill(a), padded, [7, 3])
    same(ragged)
    for i, chunk in enumerate(chunks):
        _, solo = both.cont(both.prefill(a[i:i + 1]), chunk[None])
        ts = ragged[1]
        np.testing.assert_allclose(ts.last_logits[i].numpy(), solo.last_logits[0].numpy(),
                                   atol=2e-4, rtol=2e-3)
        assert int(ts.cache.pre.length[0, i]) == int(solo.cache.pre.length[0, 0])
        assert int(ts.cache.post.length[-1, i]) == int(solo.cache.post.length[-1, 0])
        assert int(ts.next_pos[i]) == int(solo.next_pos[0])


def test_prefill_continue_ragged_then_decode():
    """After a ragged continuation, greedy decode of each sample equals its
    solo run and the JAX run (the cache contents, not only the logits)."""
    both = Both(_cfg(), 3)
    rng = np.random.default_rng(4)
    vocab = both.jcfg.text.vocab_size
    a = rng.integers(3, vocab, size=(2, 6))
    chunks = [rng.integers(3, vocab, size=(5,)), rng.integers(3, vocab, size=(2,))]
    padded = np.zeros((2, 5), np.int64)
    padded[0], padded[1, :2] = chunks
    states = both.cont(both.prefill(a), padded, [5, 2])
    toks = []
    for _ in range(3):
        states, tok = both.decode(states)
        toks.append(tok)
    same(states)
    for i, chunk in enumerate(chunks):
        _, st = both.cont(both.prefill(a[i:i + 1]), chunk[None])
        solo = []
        for _ in range(3):
            tok = torch.argmax(st.last_logits, dim=-1)
            solo.append(int(tok[0]))
            st = tdyn.decode_step(both.tp, both.tcfg, tok, st)
        assert [t[i] for t in toks] == solo


def test_prefill_continue_empty_chunk_is_noop():
    """A chunk_len of 0 persists nothing and advances nothing (a forced keep
    of column -1 would persist a padding token); the other sample keeps at
    least its last token in the post tier."""
    both = Both(_cfg(use_instruct_predictor=True), 5)
    rng = np.random.default_rng(5)
    vocab = both.jcfg.text.vocab_size
    states = both.prefill(rng.integers(3, vocab, size=(2, 6)))
    ts0 = states[1]
    pre0, post0 = ts0.cache.pre.length.clone(), ts0.cache.post.length.clone()
    pos0 = ts0.next_pos.clone()
    chunk = np.zeros((2, 4), np.int64)
    chunk[0] = rng.integers(3, vocab, size=(4,))
    states = both.cont(states, chunk, [4, 0])
    same(states, rows=[0])
    ts = states[1]
    assert int(ts.cache.pre.length[0, 1]) == int(pre0[0, 1])
    assert int(ts.cache.post.length[-1, 1]) == int(post0[-1, 1])
    assert int(ts.next_pos[1]) == int(pos0[1])
    assert int(ts.cache.pre.length[0, 0]) == int(pre0[0, 0]) + 4
    assert int(ts.cache.post.length[-1, 0]) >= int(post0[-1, 0]) + 1
    assert bool(torch.isfinite(ts.last_logits[0]).all())
