"""The slice as a whole: the port's ``Generator`` against the JAX
``Generator`` on shared (bridged) weights, fp32, tiny config.

Greedy generation must be token-exact, sparse and dense, on a batch that
mixes image and text-only samples and on an all-image batch (the two
``all_have_image`` cases of prefill), with int8 and int4 weights, with the
KV cache stored in scaled int8 and in fp8, with the ring overflow policy
past both tiers' wrap, and with a sliding window. Prefill diagnostics and
logits must agree (logits atol 1e-4), and a decode run past the post tier's
budget must force-drop at the same step on both sides.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import DENSE_SPARSE_CONFIG, LlavaConfig
from dynamic_llava_tpu.constants import IMAGE_TOKEN_INDEX
from dynamic_llava_tpu.generation.generate import GenerationConfig as JGenCfg
from dynamic_llava_tpu.generation.generate import Generator as JGen
from dynamic_llava_tpu.generation.generate import _sample as jsample
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu.multimodal.fusion import plan_batch
from dynamic_llava_tpu.ops.quant import quantize_llm_params as jquantize
from dynamic_llava_tpu_torch.generation.generate import GenerationConfig as TGenCfg
from dynamic_llava_tpu_torch.generation.generate import Generator as TGen
from dynamic_llava_tpu_torch.generation.generate import _sample as tsample
from dynamic_llava_tpu_torch.models import dynamic as tdyn
from dynamic_llava_tpu_torch.weights import params_from_numpy

from test_torch_config import port_config

SPARSE = LlavaConfig.tiny()
DENSE = LlavaConfig.tiny(sparse=DENSE_SPARSE_CONFIG)
# a small post-tier budget (decode window 2) so decode overflows it and
# force-drops; pad_multiple 8 keeps the capacity rounding from hiding that
GEN = dict(max_new_tokens=12, decode_chunk=4, pad_multiple=8, kv_window=2,
           eos_token_id=-1)


@pytest.fixture(scope="module")
def weights():
    jp = jax.jit(jdyn.init_llava_params, static_argnums=(1,))(jax.random.key(0), SPARSE)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


@pytest.fixture(scope="module", params=[8, 4], ids=["int8", "int4"])
def quantized_weights(request):
    """The same JAX weights with the decoder quantized by the JAX
    ``quantize_llm_params`` (on a copy: it mutates and donates), bridged."""
    jp = jax.jit(jdyn.init_llava_params, static_argnums=(1,))(jax.random.key(0), SPARSE)
    jp = jquantize(jax.tree.map(jnp.array, jp), bits=request.param)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


def _batch(kind):
    rng = np.random.default_rng(0)
    ids = []
    for i in range(3):
        head, tail = rng.integers(3, 500, 4 + i), rng.integers(3, 500, 6)
        with_image = kind == "all_image" or i != 1
        ids.append(np.concatenate([head, [IMAGE_TOKEN_INDEX], tail]) if with_image
                   else np.concatenate([head, tail]))
    size = SPARSE.vision.image_size
    return ids, rng.normal(size=(3, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("cfg,kind", [
    (SPARSE, "mixed"), (SPARSE, "all_image"), (DENSE, "mixed"),
], ids=["sparse-mixed", "sparse-all_image", "dense-mixed"])
def test_greedy_generate_is_token_exact(weights, cfg, kind):
    jp, tp = weights
    ids, pix = _batch(kind)
    want = JGen(jp, cfg, JGenCfg(**GEN)).generate(ids, pix)
    got = TGen(tp, port_config(cfg), TGenCfg(**GEN)).generate(ids, pix)
    assert got == want
    assert all(len(o) == GEN["max_new_tokens"] for o in got)


@pytest.mark.parametrize("cfg", [SPARSE, DENSE], ids=["sparse", "dense"])
def test_quantized_greedy_generate_is_token_exact(quantized_weights, cfg):
    """int8 and int4 weight-only serving (decoder linears, embed and
    lm_head quantized) on a batch that mixes image and text-only samples."""
    jp, tp = quantized_weights
    assert isinstance(tp["llm"]["embed"], dict)
    ids, pix = _batch("mixed")
    want = JGen(jp, cfg, JGenCfg(**GEN)).generate(ids, pix)
    got = TGen(tp, port_config(cfg), TGenCfg(**GEN)).generate(ids, pix)
    assert got == want
    assert all(len(o) == GEN["max_new_tokens"] for o in got)


@pytest.mark.parametrize("kind", ["mixed", "all_image"])
def test_prefill_and_forced_drop_match_jax(weights, kind):
    """PrefillInfo, prefill logits and cache capacities; then greedy
    decode_steps past the post-tier budget: the post-tier lengths agree at
    every step and saturate at the budget (tokens force-dropped)."""
    jp, tp = weights
    ids, pix = _batch(kind)
    # no capacity rounding and no decode headroom: the post tier's budget
    # is the longest prefill + 8 margin slots, which 40 steps overflow
    gen = dict(GEN, pad_multiple=1, kv_window=0)
    max_new = 40
    jgen, tgen = JGen(jp, SPARSE, JGenCfg(**gen)), TGen(tp, SPARSE, TGenCfg(**gen))
    plan = plan_batch(ids, SPARSE.num_image_tokens)
    jstate, jinfo = jgen.prefill_from_plan(plan, pix, max_new)
    tstate, tinfo = tgen.prefill_from_plan(plan, pix, max_new)
    np.testing.assert_array_equal(tinfo.new_length.numpy(), np.asarray(jinfo.new_length))
    np.testing.assert_array_equal(tinfo.kept_positions.numpy(),
                                  np.asarray(jinfo.kept_positions))
    np.testing.assert_array_equal(tinfo.image_keep_mask.numpy(),
                                  np.asarray(jinfo.image_keep_mask))
    np.testing.assert_allclose(tstate.last_logits.numpy(), np.asarray(jstate.last_logits),
                               atol=1e-4, rtol=1e-4)
    assert tstate.cache.post.max_len == jstate.cache.post.max_len
    assert tstate.cache.pre.max_len == jstate.cache.pre.max_len
    budget = tstate.cache.post.max_len - 1

    jstep = jax.jit(jdyn.decode_step, static_argnums=(1,))
    post = []
    for _ in range(max_new):
        jtok = jnp.argmax(jstate.last_logits, axis=-1)
        ttok = torch.argmax(tstate.last_logits, dim=-1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jstate = jstep(jp, SPARSE, jtok, jstate)
        tstate = tdyn.decode_step(tp, SPARSE, ttok, tstate)
        jlen = np.asarray(jstate.cache.post.length)
        np.testing.assert_array_equal(tstate.cache.post.length.numpy(), jlen)
        np.testing.assert_array_equal(tstate.cache.pre.length.numpy(),
                                      np.asarray(jstate.cache.pre.length))
        post.append(jlen[0])
    post = np.stack(post)  # [steps, B]
    assert (post[-1] == budget).any(), post  # the budget filled ...
    full = post == budget
    assert (post[1:][full[:-1]] == budget).all()  # ... and stayed full
    np.testing.assert_allclose(tstate.last_logits.numpy(), np.asarray(jstate.last_logits),
                               atol=1e-4, rtol=1e-4)


def test_greedy_sample_takes_the_first_maximum():
    logits = np.array([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]], np.float32)
    got = tsample(None, torch.from_numpy(logits), 0.0, 1.0)
    want = jsample(jax.random.key(0), jnp.asarray(logits), 0.0, 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [1, 0])


def test_top_p_sampling_keeps_the_nucleus():
    """Temperature/top-p draws come from a torch.Generator (the bits differ
    from JAX's): they are reproducible from the seed and never leave the
    top-p nucleus."""
    logits = torch.tensor([[4.0, 3.9, 0.0, -1.0, -2.0]] * 64)
    draw = lambda seed: tsample(torch.Generator().manual_seed(seed), logits, 0.7, 0.8)
    a, b = draw(1), draw(1)
    torch.testing.assert_close(a, b)
    assert set(a.tolist()) <= {0, 1} and len(set(a.tolist())) == 2


def test_generate_refuses_ring_overflow(weights):
    """The ring policy is served; what is still refused: a ring on a
    sliding-window model (a wrapped ring breaks slot == position), an
    unknown overflow policy and an unknown cache dtype."""
    TGen(weights[1], port_config(SPARSE), TGenCfg(kv_overflow="ring"))
    with pytest.raises(ValueError, match="kv_overflow"):
        TGen(weights[1], port_config(SPARSE), TGenCfg(kv_overflow="evict"))
    with pytest.raises(ValueError, match="cache_dtype"):
        TGen(weights[1], port_config(SPARSE), TGenCfg(cache_dtype="float16"))
    ids, pix = _batch("mixed")
    gen = TGen(weights[1], port_config(WINDOWED), TGenCfg(**dict(GEN, kv_overflow="ring")))
    with pytest.raises(ValueError, match="sliding_window"):
        gen.generate(ids, pix)


# ---------------------------------------------------------------------------
# lean-memory serving: int8 / fp8 KV caches, ring overflow, a sliding window
# ---------------------------------------------------------------------------

# the dense config with a Mistral-style window of 32 positions: the padded
# prompt (32) fits it, the 12 generated tokens slide past it
WINDOWED = dataclasses.replace(
    DENSE, text=dataclasses.replace(DENSE.text, sliding_window=32))
# both tiers' decode headroom is 2 + 8 margin slots: 40 new tokens wrap it
RING = dict(GEN, max_new_tokens=40, decode_chunk=8, kv_overflow="ring")


@pytest.mark.parametrize("cfg", [SPARSE, DENSE], ids=["sparse", "dense"])
@pytest.mark.parametrize("cache_dtype", ["int8", "float8_e4m3fn"])
def test_lean_kv_greedy_generate_is_token_exact(weights, cache_dtype, cfg):
    """Scaled-int8 and fp8 KV storage, on a batch that mixes image and
    text-only samples and force-drops past the post tier's budget."""
    jp, tp = weights
    ids, pix = _batch("mixed")
    gen = dict(GEN, cache_dtype=cache_dtype)
    want = JGen(jp, cfg, JGenCfg(**gen)).generate(ids, pix)
    got = TGen(tp, port_config(cfg), TGenCfg(**gen)).generate(ids, pix)
    assert got == want
    assert all(len(o) == GEN["max_new_tokens"] for o in got)


@pytest.mark.parametrize("cfg,cache_dtype", [
    (SPARSE, "float32"), (DENSE, "float32"), (SPARSE, "int8"),
], ids=["sparse", "dense", "sparse-int8kv"])
def test_ring_overflow_greedy_generate_is_token_exact(weights, cfg, cache_dtype):
    """``kv_overflow="ring"``: 40 new tokens at a decode window of 2, so
    both tiers wrap and every later token evicts the oldest decode entry."""
    jp, tp = weights
    ids, pix = _batch("mixed")
    gen = dict(RING, cache_dtype=cache_dtype)
    want = JGen(jp, cfg, JGenCfg(**gen)).generate(ids, pix)
    got = TGen(tp, port_config(cfg), TGenCfg(**gen)).generate(ids, pix)
    assert got == want
    assert all(len(o) == RING["max_new_tokens"] for o in got)


def test_ring_steps_match_jax_past_the_wrap(weights):
    """Step by step in ring mode: ring bases, tier lengths (which run past
    the budgets: the ring keeps counting) and the frozen-sample protocol
    (``active``), then the logits."""
    jp, tp = weights
    ids, pix = _batch("all_image")
    gen = dict(RING, pad_multiple=1)
    jgen, tgen = JGen(jp, SPARSE, JGenCfg(**gen)), TGen(tp, port_config(SPARSE), TGenCfg(**gen))
    plan = plan_batch(ids, SPARSE.num_image_tokens)
    max_new = RING["max_new_tokens"]
    jstate, _ = jgen.prefill_from_plan(plan, pix, max_new)
    tstate, _ = tgen.prefill_from_plan(plan, pix, max_new)
    np.testing.assert_array_equal(tstate.ring_base.numpy(), np.asarray(jstate.ring_base))
    np.testing.assert_array_equal(tstate.ring_base_pre.numpy(),
                                  np.asarray(jstate.ring_base_pre))
    assert (tstate.cache.pre.max_len, tstate.cache.post.max_len) == \
        (jstate.cache.pre.max_len, jstate.cache.post.max_len)
    jstep = jax.jit(jdyn.decode_step, static_argnums=(1,), static_argnames=("kv_overflow",))
    for step in range(30):
        jtok = jnp.argmax(jstate.last_logits, axis=-1)
        ttok = torch.argmax(tstate.last_logits, dim=-1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        active = np.array([True, step % 4 != 1, step < 20])  # sample 2 stops at step 20
        jstate = jstep(jp, SPARSE, jtok, jstate, jnp.asarray(active), kv_overflow="ring")
        tstate = tdyn.decode_step(tp, port_config(SPARSE), ttok, tstate,
                                  torch.from_numpy(active), kv_overflow="ring")
        np.testing.assert_array_equal(tgen.cache_lengths(tstate), jgen.cache_lengths(jstate))
        np.testing.assert_array_equal(tstate.next_pos.numpy(), np.asarray(jstate.next_pos))
    lengths = tgen.cache_lengths(tstate)
    assert (lengths[0] > tstate.cache.pre.max_len - 1).any()  # the pre tier wrapped ...
    assert (lengths[-1] > tstate.cache.post.max_len - 1).any()  # ... and the post tier
    np.testing.assert_allclose(tstate.last_logits.numpy(), np.asarray(jstate.last_logits),
                               atol=1e-4, rtol=1e-4)


def test_quantized_weights_with_int8_kv_generate_is_token_exact(quantized_weights):
    """int8 / int4 weights and the scaled-int8 KV cache together, sparse."""
    jp, tp = quantized_weights
    ids, pix = _batch("mixed")
    gen = dict(GEN, cache_dtype="int8")
    want = JGen(jp, SPARSE, JGenCfg(**gen)).generate(ids, pix)
    got = TGen(tp, port_config(SPARSE), TGenCfg(**gen)).generate(ids, pix)
    assert got == want


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_sliding_window_greedy_generate_is_token_exact(weights, cache_dtype):
    """A dense model with ``sliding_window=32``: the generated positions
    run past the window, so decode masks the oldest columns by position."""
    jp, tp = weights
    ids, pix = _batch("mixed")
    gen = dict(GEN, cache_dtype=cache_dtype)
    want = JGen(jp, WINDOWED, JGenCfg(**gen)).generate(ids, pix)
    got = TGen(tp, port_config(WINDOWED), TGenCfg(**gen)).generate(ids, pix)
    assert got == want
    # the window does change what is generated, or this test would not see it
    assert want != JGen(jp, DENSE, JGenCfg(**gen)).generate(ids, pix)


# ---------------------------------------------------------------------------
# paths no earlier case reached: the instruct-predictor prune of prefill, an
# EOS inside a chunk with the stopping and streaming callbacks, and the
# keyword-only options of the port's prefill
# ---------------------------------------------------------------------------

INSTRUCT = dataclasses.replace(
    SPARSE, sparse=dataclasses.replace(SPARSE.sparse, use_instruct_predictor=True))
USER = (7, 8)  # stands in for the "USER:" token pair inside the tiny vocabulary


@pytest.fixture(scope="module")
def instruct_weights():
    jp = jax.jit(jdyn.init_llava_params, static_argnums=(1,))(jax.random.key(1), INSTRUCT)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


def _instruct_batch():
    """The mixed batch with a last-instruction span of 9-11 text tokens after
    the image (or, in the text-only sample, after the head)."""
    rng = np.random.default_rng(3)
    ids = []
    for i in range(3):
        head = rng.integers(9, 500, 4 + i)
        instr = np.concatenate([USER, rng.integers(9, 500, 7 + i)])
        ids.append(np.concatenate([head, [IMAGE_TOKEN_INDEX], instr]) if i != 1
                   else np.concatenate([head, instr]))
    size = SPARSE.vision.image_size
    return ids, rng.normal(size=(3, size, size, 3)).astype(np.float32)


def test_instruct_predictor_prune_matches_jax(instruct_weights):
    """``use_instruct_predictor=True`` (the E2 prune of prefill) on the mixed
    batch: ``PrefillInfo`` is equal, the prune removed instruction tokens,
    the prefill logits agree (atol = rtol = 1e-4: fp32 sums in another
    order) and 12 greedy decode steps are token-exact."""
    jp, tp = instruct_weights
    ids, pix = _instruct_batch()
    n_img = INSTRUCT.num_image_tokens
    plan = plan_batch(ids, n_img, user_tokens=USER, pad_multiple=GEN["pad_multiple"])
    spans = plan.spans
    assert (np.asarray(spans.last_instruct_end) - np.asarray(spans.last_instruct_start)
            >= 9).all()
    steps = 12
    jgen = JGen(jp, INSTRUCT, JGenCfg(**GEN))
    tgen = TGen(tp, port_config(INSTRUCT), TGenCfg(**GEN))
    jstate, jinfo = jgen.prefill_from_plan(plan, pix, steps)
    tstate, tinfo = tgen.prefill_from_plan(plan, pix, steps)
    np.testing.assert_array_equal(tinfo.new_length.numpy(), np.asarray(jinfo.new_length))
    np.testing.assert_array_equal(tinfo.kept_positions.numpy(),
                                  np.asarray(jinfo.kept_positions))
    np.testing.assert_array_equal(tinfo.image_keep_mask.numpy(),
                                  np.asarray(jinfo.image_keep_mask))
    # the instruct prune took something beyond the image prune
    image_only = np.asarray(plan.valid_len) - np.where(
        np.asarray(spans.has_image), n_img - INSTRUCT.vision_keep_budget, 0)
    assert (tinfo.new_length.numpy() < image_only).any()
    np.testing.assert_allclose(tstate.last_logits.numpy(), np.asarray(jstate.last_logits),
                               atol=1e-4, rtol=1e-4)
    jstep = jax.jit(jdyn.decode_step, static_argnums=(1,))
    for _ in range(steps):
        jtok = jnp.argmax(jstate.last_logits, axis=-1)
        ttok = torch.argmax(tstate.last_logits, dim=-1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jstate = jstep(jp, INSTRUCT, jtok, jstate)
        tstate = tdyn.decode_step(tp, port_config(INSTRUCT), ttok, tstate)
    np.testing.assert_allclose(tstate.last_logits.numpy(), np.asarray(jstate.last_logits),
                               atol=1e-4, rtol=1e-4)


def test_eos_stopping_criteria_and_on_chunk_match_jax(weights):
    """A reachable ``eos_token_id`` inside a chunk, a ``stopping_criteria``
    callback and an ``on_chunk`` callback: outputs, the streamed chunks and
    the sequences the criterion saw are equal to the JAX ``Generator``'s."""
    jp, tp = weights
    ids, pix = _batch("mixed")
    free = JGen(jp, SPARSE, JGenCfg(**GEN)).generate(ids, pix)
    # sample 0 ends at its 6th token (the 2nd slot of the 2nd chunk of 4) by
    # EOS; the criterion ends sample 1 once its 7th token is out
    eos = free[0][5]
    stop_tok, stop_at = free[1][6], 7
    assert eos not in free[1][:stop_at] and eos not in free[2]
    gen = dict(GEN, eos_token_id=int(eos))

    def run(generator):
        seen, chunks = [], []

        def criterion(seq):
            seq = [int(t) for t in seq]
            seen.append(seq)
            return len(seq) >= stop_at and seq[-1] == stop_tok and seq[-2] == free[1][5]

        out = generator.generate(ids, pix, stopping_criteria=criterion,
                                 on_chunk=lambda i, new: chunks.append((i, list(map(int, new)))))
        return out, seen, chunks

    jout, jseen, jchunks = run(JGen(jp, SPARSE, JGenCfg(**gen)))
    tout, tseen, tchunks = run(TGen(tp, port_config(SPARSE), TGenCfg(**gen)))
    assert tout == jout
    assert tchunks == jchunks
    assert tseen == jseen
    assert tout[0] == free[0][:free[0].index(eos) + 1] and len(tout[0]) < len(free[0])
    assert len(tout[1]) < len(free[1]) and tout[1] == free[1][:len(tout[1])]
    assert tout[2] == free[2]  # the third sample runs to max_new_tokens
    for i, out in enumerate(tout):  # the chunks are the outputs, in order
        assert [t for j, new in tchunks if j == i for t in new] == out


def test_prefill_options_are_keyword_only(weights):
    """The reference's ``prefill`` has ``image_features`` where the port had
    ``all_have_image``: a positional call written for the reference must
    raise here, not bind a tensor to a flag."""
    _, tp = weights
    ids, pix = _batch("all_image")
    cfg = port_config(SPARSE)
    plan = plan_batch(ids, SPARSE.num_image_tokens)
    i32 = torch.int32
    args = (torch.as_tensor(plan.token_ids, dtype=i32),
            torch.as_tensor(plan.is_image), torch.as_tensor(plan.image_slot, dtype=i32),
            torch.as_tensor(plan.valid_len, dtype=i32),
            torch.as_tensor(plan.spans.image_start, dtype=i32),
            torch.as_tensor(plan.spans.last_instruct_start, dtype=i32),
            torch.as_tensor(plan.spans.last_instruct_end, dtype=i32),
            torch.as_tensor(plan.spans.has_image), torch.from_numpy(pix))
    cache = tdyn.make_gen_cache(cfg, plan.batch, plan.seq_len, 4, torch.float32,
                                all_have_image=True, device="cpu")
    with pytest.raises(TypeError, match="positional"):
        tdyn.prefill(tp, cfg, *args, cache, None)  # the reference's image_features slot
    with pytest.raises(TypeError, match="positional"):
        tdyn.prefill(tp, cfg, *args, cache, True, False)
    state, info = tdyn.prefill(tp, cfg, *args, cache, all_have_image=True, ring_mode=True)
    assert state.ring_base is not None
    assert info.kept_positions.shape[1] == \
        plan.seq_len - SPARSE.num_image_tokens + SPARSE.vision_keep_budget
