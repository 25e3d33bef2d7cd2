"""The Mistral family (LLaMA + GQA + a sliding window) in the port against
the JAX package, fp32, tiny sizes, with the window binding: the no-cache
forward (``run_layers_nocache`` / ``forward_dense``: ROADMAP C38, where the
port used to attend past the window), the cached prefill past the window,
decode past it and a chunked extend across it (against JAX and against the
port's own no-cache forward, as ``tests/test_mistral_parity.py`` holds the
JAX paths), greedy ``Generator`` tokens, and the refusal of the sparse
predictors. Tolerance: atol 1e-5 / rtol 1e-4 on hidden states, atol 1e-4 /
rtol 1e-3 on logits."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu import config as jconfig
from dynamic_llava_tpu.config import DENSE_SPARSE_CONFIG, LlamaConfig, LlavaConfig
from dynamic_llava_tpu.generation.generate import GenerationConfig as JGenCfg
from dynamic_llava_tpu.generation.generate import Generator as JGen
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu.models import llama as jllama
from dynamic_llava_tpu.ops import kv_cache as jkv
from dynamic_llava_tpu_torch import config as tconfig
from dynamic_llava_tpu_torch.generation.generate import GenerationConfig as TGenCfg
from dynamic_llava_tpu_torch.generation.generate import Generator as TGen
from dynamic_llava_tpu_torch.models import llama as tllama
from dynamic_llava_tpu_torch.ops import kv_cache as tkv
from dynamic_llava_tpu_torch.weights import params_from_numpy

from test_torch_config import port_config

WINDOW = 8
CFG = LlamaConfig.tiny(num_key_value_heads=2, sliding_window=WINDOW)  # GQA 4 / 2
ATOL, RTOL = 1e-5, 1e-4
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def decoder():
    jp = jllama.init_llama_params(jax.random.key(3), CFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


# one compile a shape for the JAX decode loop
_jdecode = jax.jit(lambda p, x, pos, c: jllama.run_layers_decode(p, CFG, x, pos, c))
_jhead = jax.jit(lambda p, x: jllama.lm_head(p, CFG, x))
# and for the no-cache forwards, the prefill and the extend
_jnocache = jax.jit(lambda p, x, pos: jllama.run_layers_nocache(p, CFG, x, pos))
_jdense = jax.jit(lambda p, ids: jllama.forward_dense(p, CFG, ids))
_jprefill = jax.jit(lambda p, ids, pos, c, v: jllama.run_layers_prefill(
    p, CFG, jllama.embed_tokens(p, ids), pos, c, v))
_jextend = jax.jit(lambda p, ids, pos, c: jllama.run_layers_extend(
    p, CFG, jllama.embed_tokens(p, ids), pos, c))


def _ids(b, s, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("s", [2 * WINDOW + 1, WINDOW + 1, WINDOW])
def test_nocache_forward_with_the_window_matches_jax(decoder, s):
    """ROADMAP C38: ``run_layers_nocache`` and ``forward_dense`` with the
    window binding (S > window) equal JAX's; the same port stack without a
    window differs on the rows past it, so the window is live."""
    jp, tp = decoder
    tcfg = port_config(CFG)
    b = 2
    x = np.random.default_rng(s).normal(size=(b, s, CFG.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    want = np.asarray(_jnocache(jp, jnp.asarray(x), jnp.asarray(pos)))
    got = tllama.run_layers_nocache(tp, tcfg, torch.from_numpy(x),
                                    torch.from_numpy(np.ascontiguousarray(pos)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)

    ids = _ids(b, s, s + 1)
    want = np.asarray(_jdense(jp, jnp.asarray(ids)))
    got = tllama.forward_dense(tp, tcfg, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    no_window = tllama.forward_dense(tp, dataclasses.replace(tcfg, sliding_window=None),
                                     torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(no_window[:, :WINDOW], got[:, :WINDOW], atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    if s > WINDOW:
        assert not np.allclose(no_window[:, WINDOW:], got[:, WINDOW:], atol=1e-3)


def test_nocache_with_an_explicit_mask_ands_the_window(decoder):
    """A caller's mask (padding) is ANDed with the window, as in JAX."""
    jp, tp = decoder
    b, s = 2, 2 * WINDOW + 3
    x = np.random.default_rng(7).normal(size=(b, s, CFG.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    valid = np.array([s, s - 5], np.int32)
    jmask = jllama.make_attention_mask(s, s, causal=True, kv_length=jnp.asarray(valid), batch=b)
    want = np.asarray(jllama.run_layers_nocache(jp, CFG, jnp.asarray(x), jnp.asarray(pos),
                                                mask=jmask))
    got = tllama.run_layers_nocache(tp, port_config(CFG), torch.from_numpy(x),
                                    torch.from_numpy(np.ascontiguousarray(pos)),
                                    mask=torch.from_numpy(np.array(jmask)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("s", [2 * WINDOW + 1])
def test_prefill_past_the_window_then_decode_matches_jax_and_nocache(decoder, s):
    """The cached prefill of a prompt longer than the window (the plain
    path under the window mask), then greedy decode well past it: every
    step's logits equal JAX's and the port's no-cache forward over the
    growing sequence; the caches equal JAX's."""
    jp, tp = decoder
    tcfg = port_config(CFG)
    b, n_decode = 2, WINDOW + 4
    max_len = s + n_decode + 1
    ids = _ids(b, s, s)
    jc = jkv.init_cache(CFG, b, max_len, dtype=jnp.float32)
    tc = tkv.init_cache(tcfg, b, max_len, torch.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    valid = np.full((b,), s, np.int32)
    jr = _jprefill(jp, jnp.asarray(ids), jnp.asarray(pos), jc, jnp.asarray(valid))
    tr = tllama.run_layers_prefill(tp, tcfg, tllama.embed_tokens(tp, torch.from_numpy(ids)),
                                   torch.from_numpy(np.ascontiguousarray(pos)), tc,
                                   torch.from_numpy(valid))
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=ATOL, rtol=RTOL)
    jc, tc = jr.cache, tr.cache
    jl = np.asarray(_jhead(jp, jr.x))[:, s - 1]
    tl = tllama.lm_head(tp, tcfg, tr.x)[:, s - 1]
    seq = torch.from_numpy(ids)
    for step in range(n_decode):
        np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        ref = tllama.forward_dense(tp, tcfg, seq)[:, -1]
        np.testing.assert_allclose(tl.numpy(), ref.numpy(), atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        nxt = torch.argmax(tl, dim=-1).to(torch.int32)
        assert np.array_equal(nxt.numpy(), np.argmax(jl, axis=-1))
        seq = torch.cat([seq, nxt[:, None]], dim=1)
        p = np.full((b, 1), s + step, np.int32)
        jtok = jnp.asarray(nxt.numpy())[:, None]
        jd = _jdecode(jp, jllama.embed_tokens(jp, jtok), jnp.asarray(p), jc)
        td = tllama.run_layers_decode(tp, tcfg, tllama.embed_tokens(tp, nxt[:, None]),
                                      torch.from_numpy(p), tc)
        jc = jd.cache._replace(length=jd.cache.length + 1)
        tc = td.cache._replace(length=td.cache.length + 1)
        jl = np.asarray(_jhead(jp, jd.x))[:, 0]
        tl = tllama.lm_head(tp, tcfg, td.x)[:, 0]
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("s1", [WINDOW - 2, WINDOW + 3])
def test_extend_across_the_window_matches_jax_and_nocache(decoder, s1):
    """A chunked continuation whose rows span the window's edge, after a
    prefill inside (s1 < window) or past (s1 > window) it."""
    jp, tp = decoder
    tcfg = port_config(CFG)
    b, m = 2, WINDOW
    max_len = s1 + m + 4
    ids = _ids(b, s1 + m, 20 + s1)
    jc = jkv.init_cache(CFG, b, max_len, dtype=jnp.float32)
    tc = tkv.init_cache(tcfg, b, max_len, torch.float32)
    pos1 = np.broadcast_to(np.arange(s1, dtype=np.int32)[None], (b, s1))
    valid = np.full((b,), s1, np.int32)
    jr = _jprefill(jp, jnp.asarray(ids[:, :s1]), jnp.asarray(pos1), jc, jnp.asarray(valid))
    tr = tllama.run_layers_prefill(tp, tcfg,
                                   tllama.embed_tokens(tp, torch.from_numpy(ids[:, :s1])),
                                   torch.from_numpy(np.ascontiguousarray(pos1)), tc,
                                   torch.from_numpy(valid))
    pos2 = np.broadcast_to((s1 + np.arange(m, dtype=np.int32))[None], (b, m))
    je = _jextend(jp, jnp.asarray(ids[:, s1:]), jnp.asarray(pos2), jr.cache)
    te = tllama.run_layers_extend(tp, tcfg, tllama.embed_tokens(tp, torch.from_numpy(ids[:, s1:])),
                                  torch.from_numpy(np.ascontiguousarray(pos2)), tr.cache)
    got = tllama.lm_head(tp, tcfg, te.x).numpy()
    np.testing.assert_allclose(got, np.asarray(_jhead(jp, je.x)),
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    ref = tllama.forward_dense(tp, tcfg, torch.from_numpy(ids)).numpy()[:, s1:]
    np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


DENSE = LlavaConfig.tiny(sparse=DENSE_SPARSE_CONFIG)
WINDOWED = dataclasses.replace(DENSE, text=dataclasses.replace(
    DENSE.text, num_key_value_heads=2, sliding_window=WINDOW))
GEN = dict(max_new_tokens=12, decode_chunk=4, pad_multiple=8, eos_token_id=-1)


@pytest.mark.parametrize("cache_dtype", ["float32"])
def test_greedy_generator_with_prompts_past_the_window_is_token_exact(cache_dtype):
    """Text prompts of 11 and 19 tokens (padded to 24) against a window of
    8: the cached prefill takes the window mask, decode the windowed K2
    path. Tokens equal the JAX ``Generator``'s, and differ from the same
    model without a window."""
    jp = jax.jit(jdyn.init_llava_params, static_argnums=(1,))(jax.random.key(5), WINDOWED)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    rng = np.random.default_rng(9)
    ids = [rng.integers(3, 500, n) for n in (11, 19)]
    gen = dict(GEN, cache_dtype=cache_dtype)
    want = JGen(jp, WINDOWED, JGenCfg(**gen)).generate(ids)
    got = TGen(tp, port_config(WINDOWED), TGenCfg(**gen)).generate(ids)
    assert got == want and all(len(t) == GEN["max_new_tokens"] for t in got)
    tcfg = port_config(WINDOWED)
    unwindowed = dataclasses.replace(tcfg, text=dataclasses.replace(tcfg.text,
                                                                    sliding_window=None))
    assert got != TGen(tp, unwindowed, TGenCfg(**gen)).generate(ids)


@pytest.mark.parametrize("predictor", ["use_vision_predictor", "use_text_predictor",
                                       "use_output_text_predictor", "use_instruct_predictor"])
def test_a_window_with_a_sparse_predictor_is_refused_as_in_jax(predictor):
    """``LlavaConfig`` refuses a sliding window with any predictor on (JAX
    ``config.py``: compaction breaks the slot == position invariant of the
    window mask); both packages raise the same error."""
    for mod in (jconfig, tconfig):
        sparse = dataclasses.replace(mod.DENSE_SPARSE_CONFIG, **{predictor: True})
        text = mod.LlamaConfig.tiny(sliding_window=WINDOW)
        with pytest.raises(ValueError, match="sliding_window"):
            mod.LlavaConfig(text=text, vision=mod.ClipVisionConfig.tiny(), sparse=sparse)
        mod.LlavaConfig(text=text, vision=mod.ClipVisionConfig.tiny(),
                        sparse=mod.DENSE_SPARSE_CONFIG)
