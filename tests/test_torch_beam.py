"""The port's beam search against the JAX package's on shared (bridged)
weights, fp32, tiny config.

``reorder_cache`` / ``reorder_state`` give the bytes of the JAX functions
on the same cache (bf16 and scaled-int8 tiers, with and without ring
bases); ``beam_search`` gives the JAX ``beam_search``'s tokens for W = 1
and W = 3, with EOS unreachable and reachable; the best beam's
log-probability (``sequence_logprob``) is at least greedy's at 6 and 8
tokens; a ring state is refused.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import LlavaConfig, SparseConfig
from dynamic_llava_tpu.generation import beam as jbeam
from dynamic_llava_tpu.generation.generate import GenerationConfig as JGenCfg
from dynamic_llava_tpu.generation.generate import Generator as JGen
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu.ops.kv_cache import KVCache as JKV
from dynamic_llava_tpu.ops.kv_cache import TieredCache as JTiered
from dynamic_llava_tpu_torch.generation import beam as tbeam
from dynamic_llava_tpu_torch.generation.generate import GenerationConfig as TGenCfg
from dynamic_llava_tpu_torch.generation.generate import Generator as TGen
from dynamic_llava_tpu_torch.models import dynamic as tdyn
from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
from dynamic_llava_tpu_torch.ops.kv_cache import KVCache as TKV
from dynamic_llava_tpu_torch.ops.kv_cache import TieredCache as TTiered
from dynamic_llava_tpu_torch.weights import params_from_numpy

from test_torch_config import port_config

W = 3


def _raw_np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.view(f"u{a.dtype.itemsize}")


def _raw_t(t: torch.Tensor) -> np.ndarray:
    return _raw_np(t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()]).numpy())


def _tier(rng, layers, b, s, int8):
    """The same random tier for both packages: k, v, length (and scales)."""
    shape = (layers, b, s, 2, 8)
    if int8:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.random(shape[:-1]).astype(np.float32) for _ in range(2))
        jt = JKV(jnp.asarray(k), jnp.asarray(v), None, jnp.asarray(ks, jnp.bfloat16),
                 jnp.asarray(vs, jnp.bfloat16))
        tt = TKV(torch.from_numpy(k), torch.from_numpy(v), None,
                 torch.from_numpy(ks).to(torch.bfloat16), torch.from_numpy(vs).to(torch.bfloat16))
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        jt = JKV(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), None)
        tt = TKV(torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(v).to(torch.bfloat16),
                 None)
    length = rng.integers(0, s, (layers, b)).astype(np.int32)
    return jt._replace(length=jnp.asarray(length)), tt._replace(length=torch.from_numpy(length))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ring", [False, True], ids=["drop", "ring"])
def test_reorder_state_is_byte_equal_to_jax(int8, ring):
    rng = np.random.default_rng(int(int8) + 2 * int(ring))
    b = 4
    (jpre, tpre), (jpost, tpost) = _tier(rng, 2, b, 12, int8), _tier(rng, 3, b, 7, int8)
    next_pos = rng.integers(0, 50, b).astype(np.int32)
    logits = rng.standard_normal((b, 33)).astype(np.float32)
    bases = [rng.integers(0, 7, b).astype(np.int32) for _ in range(2)] if ring else [None] * 2
    jstate = jdyn.GenState(JTiered(jpre, jpost), jnp.asarray(next_pos), jnp.asarray(logits),
                           *(None if x is None else jnp.asarray(x) for x in bases))
    tstate = tdyn.GenState(TTiered(tpre, tpost), torch.from_numpy(next_pos),
                           torch.from_numpy(logits),
                           *(None if x is None else torch.from_numpy(x) for x in bases))
    idx = np.array([2, 2, 0, 3], np.int32)
    want = jbeam.reorder_state(jstate, jnp.asarray(idx))
    got = tbeam.reorder_state(tstate, torch.from_numpy(idx))
    for jt, tt in zip(want.cache, got.cache):
        for name, a, c in zip(jt._fields, jt, tt):
            assert (a is None) == (c is None), name
            if a is not None:
                assert a.dtype.itemsize == c.element_size(), name
                np.testing.assert_array_equal(_raw_t(c), _raw_np(a), err_msg=name)
    for name in ("next_pos", "last_logits", "ring_base", "ring_base_pre"):
        a, c = getattr(want, name), getattr(got, name)
        assert (a is None) == (c is None), name
        if a is not None:
            np.testing.assert_array_equal(_raw_t(c), _raw_np(a), err_msg=name)
    # the cache given is left as it was
    np.testing.assert_array_equal(_raw_t(tstate.cache.pre.k), _raw_np(jstate.cache.pre.k))


def _cfg():
    sparse = SparseConfig(
        use_vision_predictor=False, use_text_predictor=False,
        use_output_text_predictor=False, use_instruct_predictor=False,
        d_model=32, nhead=2, dim_feedforward=64, num_layers=1,
    )
    return LlavaConfig.tiny(sparse=sparse)


@pytest.fixture(scope="module")
def models():
    cfg = _cfg()
    jp = jax.jit(jdyn.init_llava_params, static_argnums=(1,))(jax.random.key(2), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    return cfg, jp, tp


def _states(models, w, max_new, **gen):
    """The JAX and the port's prefilled states of ``w`` copies of one prompt
    (the JAX test's prompt), sized for ``max_new`` new tokens."""
    cfg, jp, tp = models
    ids = np.random.default_rng(2).integers(3, cfg.text.vocab_size, (7,))
    plan = plan_batch([ids] * w, 0, pad_multiple=1)
    gc = dict(max_new_tokens=max_new, pad_multiple=1, **gen)
    jstate, _ = JGen(jp, cfg, JGenCfg(**gc)).prefill_from_plan(plan, None, max_new)
    tgen = TGen(tp, port_config(cfg), TGenCfg(**gc))
    with torch.inference_mode():
        tstate, _ = tgen.prefill_from_plan(plan, None, max_new)
    return ids, jstate, tstate, tgen


@pytest.mark.parametrize("w,max_new", [(1, 6), (W, 5), (W, 6)])
def test_beam_search_matches_jax(models, w, max_new):
    cfg, jp, tp = models
    _, jstate, tstate, _ = _states(models, w, max_new)
    want = jbeam.beam_search(jp, cfg, jstate, num_beams=w, max_new_tokens=max_new,
                             eos_token_id=-1)
    got = tbeam.beam_search(tp, port_config(cfg), tstate, num_beams=w,
                            max_new_tokens=max_new, eos_token_id=-1)
    assert got == [int(t) for t in want]
    assert len(got) == max_new and all(0 <= t < cfg.text.vocab_size for t in got)


def test_beam_search_with_eos_matches_jax(models):
    """A reachable EOS: finished beams are ranked by length-normalised
    score, as in JAX."""
    cfg, jp, tp = models
    max_new = 8
    _, jstate, tstate, _ = _states(models, W, max_new)
    free = tbeam.beam_search(tp, port_config(cfg), tstate, num_beams=W,
                             max_new_tokens=max_new, eos_token_id=-1)
    eos = free[2]  # a token a beam emits
    _, jstate, tstate, _ = _states(models, W, max_new)
    want = jbeam.beam_search(jp, cfg, jstate, num_beams=W, max_new_tokens=max_new,
                             eos_token_id=eos, length_penalty=0.8)
    got = tbeam.beam_search(tp, port_config(cfg), tstate, num_beams=W,
                            max_new_tokens=max_new, eos_token_id=eos, length_penalty=0.8)
    assert got == [int(t) for t in want]


@pytest.mark.parametrize("max_new", [6, 8])
def test_beam_logprob_at_least_greedy(models, max_new):
    """Beam search keeps W prefixes, so it usually scores at least the greedy
    chain; it is not a law: at 5 tokens this model's W=3 beam prunes the
    greedy prefix and scores -29.0182 against greedy's -29.0135, in both
    packages (their tokens are equal, ``test_beam_search_matches_jax``)."""
    cfg, jp, tp = models
    ids, _, tstate, tgen = _states(models, W, max_new, eos_token_id=-1)
    best = tbeam.beam_search(tp, port_config(cfg), tstate, num_beams=W,
                             max_new_tokens=max_new, eos_token_id=-1)
    greedy = tgen.generate([ids])[0]
    assert len(best) == len(greedy) == max_new
    plan = plan_batch([ids], 0, pad_multiple=1)
    scores = []
    for toks in (best, greedy):
        with torch.inference_mode():
            state, _ = tgen.prefill_from_plan(plan, None, max_new)
        scores.append(tbeam.sequence_logprob(tp, port_config(cfg), state, toks))
    assert scores[0] >= scores[1] - 1e-6, scores


def test_beam_search_refuses_ring_state(models):
    cfg, _, tp = models
    _, _, tstate, _ = _states(models, 2, 4, kv_overflow="ring", kv_window=2)
    assert tstate.ring_base is not None
    with pytest.raises(ValueError, match="drop-mode"):
        tbeam.beam_search(tp, port_config(cfg), tstate, num_beams=2, max_new_tokens=4)
