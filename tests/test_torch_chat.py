"""The port's multi-round ``ChatSession`` against the JAX ``ChatSession`` on
shared (bridged) weights, fp32, tiny config.

The cases of ``tests/test_chat_chunked.py``, each held against the JAX
session as well as the port's own per-token path: chunked decode against
``_ask_tokenwise`` without EOS, with EOS in mid-chunk and a second round,
with a keyword stop, with the output-text predictor's keep gating, a stop
that only the decoded-text fallback sees (the state rebuilt by replay), the
fallback agreeing with the token matcher, ``max_new_tokens=0``, and a limit
that is not a multiple of the chunk. Then a three-round greedy chat (an
image in round 1), sparse (vision, output-text and instruct predictors) and
dense, on bf16 and int8 KV caches: token-exact, with the tier lengths and
``next_pos`` equal after every round; the refusal of the ring overflow
policy; a chunk larger than the pre tier's room; and a ``Generator.generate``
call between two rounds, which must leave the session's state alone (the
session owns its runner). Logits within atol 2e-4 / rtol 2e-3, as in the
JAX test.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from dynamic_llava_tpu.config import LlavaConfig, SparseConfig
from dynamic_llava_tpu.constants import IMAGE_TOKEN_INDEX
from dynamic_llava_tpu.generation.generate import ChatSession as JChat
from dynamic_llava_tpu.generation.generate import GenerationConfig as JGenCfg
from dynamic_llava_tpu.generation.generate import Generator as JGen
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu_torch.generation.generate import ChatSession as TChat
from dynamic_llava_tpu_torch.generation.generate import GenerationConfig as TGenCfg
from dynamic_llava_tpu_torch.generation.generate import Generator as TGen
from dynamic_llava_tpu_torch.generation.generate import StopDecodeRunner
from dynamic_llava_tpu_torch.weights import params_from_numpy

from test_torch_config import port_config

_jinit = jax.jit(jdyn.init_llava_params, static_argnums=(1,))


def _cfg(**sparse_overrides):
    sparse = SparseConfig(
        d_model=32, nhead=2, dim_feedforward=64, num_layers=1,
        use_vision_predictor=False, use_text_predictor=False,
        use_output_text_predictor=False, use_instruct_predictor=False,
    )
    return LlavaConfig.tiny(sparse=dataclasses.replace(sparse, **sparse_overrides))


class Pair:
    """A JAX and a port ``Generator`` on the same weights and settings."""

    def __init__(self, cfg, seed=0, **gen):
        self.cfg = cfg
        self.jp = _jinit(jax.random.key(seed), cfg)
        self.tp = params_from_numpy(jax.tree.map(np.asarray, self.jp), "cpu", torch.float32)
        self.set(**gen)

    def set(self, eos=None, max_new=10, chunk=4, **gen):
        gc = dict(max_new_tokens=max_new, decode_chunk=chunk,
                  eos_token_id=self.cfg.text.vocab_size + 7 if eos is None else eos, **gen)
        self.jgen = JGen(self.jp, self.cfg, JGenCfg(**gc))
        self.tgen = TGen(self.tp, port_config(self.cfg), TGenCfg(**gc))
        return self

    def sessions(self, total=96):
        return JChat(self.jgen, max_new_tokens_total=total), TChat(self.tgen, total)


def _tokenwise(gen, prompt, rounds=(), crit=None, max_new=None):
    """Ground truth: a fresh port session driven through the per-token path."""
    session = TChat(gen, max_new_tokens_total=96)
    max_new = gen.gen_cfg.max_new_tokens if max_new is None else max_new
    session._start_round(prompt, None)
    outs = [session._ask_tokenwise(crit, max_new)]
    for chunk in rounds:
        session._start_round(chunk, None)
        outs.append(session._ask_tokenwise(None, max_new))
    return outs, session


def _lengths(session):
    st = session.state
    return (np.asarray(st.cache.pre.length), np.asarray(st.cache.post.length),
            int(np.asarray(st.next_pos)[0]))


def _same_state(a, b, logits=True):
    """Tier lengths, ``next_pos`` and the last logits of two sessions (of
    either package)."""
    for x, y in zip(_lengths(a)[:2], _lengths(b)[:2]):
        np.testing.assert_array_equal(x, y)
    assert _lengths(a)[2] == _lengths(b)[2]
    if logits:
        np.testing.assert_allclose(np.asarray(a.state.last_logits),
                                   np.asarray(b.state.last_logits), atol=2e-4, rtol=2e-3)


def test_chunked_matches_tokenwise_no_eos():
    pair = Pair(_cfg())
    prompt = np.random.default_rng(0).integers(3, pair.cfg.text.vocab_size, size=(9,))
    ref, ref_session = _tokenwise(pair.tgen, prompt)
    js, ts = pair.sessions()
    out = ts.ask(prompt)
    assert out == ref[0] == js.ask(prompt)
    _same_state(ts, ref_session)
    _same_state(ts, js)


def test_chunked_matches_tokenwise_with_eos_and_round2():
    pair = Pair(_cfg())
    rng = np.random.default_rng(1)
    prompt = rng.integers(3, pair.cfg.text.vocab_size, size=(8,))
    # a token the model emits becomes EOS, so the stop fires in mid-chunk
    toks = pair.sessions()[1].ask(prompt)
    assert len(toks) == 10
    pair.set(eos=toks[2])
    round2 = rng.integers(3, pair.cfg.text.vocab_size, size=(5,))
    ref, ref_session = _tokenwise(pair.tgen, prompt, rounds=[round2])
    assert len(ref[0]) < 10  # EOS fired
    js, ts = pair.sessions()
    out1, out2 = ts.ask(prompt), ts.ask(round2)
    assert [out1, out2] == ref == [js.ask(prompt), js.ask(round2)]
    # the cache after two rounds is the per-token path's: a chunk's overshoot
    # persisted nothing
    _same_state(ts, ref_session)
    _same_state(ts, js)


class FakeKeywords:
    """A ``KeywordsStoppingCriteria``-shaped criteria: token sequences."""

    def __init__(self, stop_seq, tokenizer=False):
        self.keyword_ids = [stop_seq]
        if tokenizer:
            self.tokenizer = object()  # a text fallback that agrees

    def __call__(self, out):
        n = len(self.keyword_ids[0])
        return len(out) >= n and out[-n:] == self.keyword_ids[0]


@pytest.mark.parametrize("with_text_fallback", [False, True],
                         ids=["keyword", "keyword-and-agreeing-text-fallback"])
def test_chunked_keyword_stop_matches_tokenwise(with_text_fallback):
    """A keyword criteria stops on the device where the host-side criteria
    would (with a text fallback that agrees, without a rebuild)."""
    pair = Pair(_cfg(), seed=3, max_new=12, chunk=5)
    prompt = np.random.default_rng(3).integers(3, pair.cfg.text.vocab_size, size=(7,))
    toks = pair.sessions()[1].ask(prompt)
    stop_seq = toks[4:6]  # the 2-token sequence ending at position 5
    crit = FakeKeywords(stop_seq, with_text_fallback)
    ref, ref_session = _tokenwise(pair.tgen, prompt, crit=crit)
    assert ref[0] == toks[:6]
    js, ts = pair.sessions()
    out = ts.ask(prompt, stopping_criteria=crit)
    assert out == ref[0] == js.ask(prompt, stopping_criteria=crit)
    _same_state(ts, ref_session)
    _same_state(ts, js)


def test_chunked_sparse_decode_keep_gating():
    """With the output-text predictor, a frozen sample advances neither tier;
    chunked == per-token == JAX on lengths and tokens."""
    pair = Pair(_cfg(use_output_text_predictor=True, output_text_keep_rate=0.5), seed=4,
                max_new=9, chunk=4)
    prompt = np.random.default_rng(4).integers(3, pair.cfg.text.vocab_size, size=(8,))
    toks = pair.sessions()[1].ask(prompt)
    pair.set(eos=toks[3], max_new=9, chunk=4)
    ref, ref_session = _tokenwise(pair.tgen, prompt)
    js, ts = pair.sessions()
    out = ts.ask(prompt)
    assert out == ref[0] == js.ask(prompt)
    _same_state(ts, ref_session)
    _same_state(ts, js)


class TextOnlyKeywords:
    # the advertised token sequence never matches a sampled token, so only
    # the decoded-text fallback (marked by ``tokenizer``) fires
    keyword_ids = [[10**6]]
    tokenizer = object()

    def __call__(self, out):
        return len(out) >= 6


def test_text_fallback_stop_rebuilds_exactly():
    """A stop that only the decoded-text fallback sees stops where the
    per-token path stops, and the replay leaves the live state that path's:
    round 2 matches token for token."""
    pair = Pair(_cfg(), seed=6, max_new=12, chunk=5)
    rng = np.random.default_rng(6)
    prompt = rng.integers(3, pair.cfg.text.vocab_size, size=(7,))
    round2 = rng.integers(3, pair.cfg.text.vocab_size, size=(4,))
    ref_session = TChat(pair.tgen, max_new_tokens_total=96)
    ref_session._start_round(prompt, None)
    ref1 = ref_session._ask_tokenwise(TextOnlyKeywords(), 12)
    assert len(ref1) == 6
    ref_session._start_round(round2, None)
    ref2 = ref_session._ask_tokenwise(None, 12)
    js, ts = pair.sessions()
    assert ts.ask(prompt, stopping_criteria=TextOnlyKeywords()) == ref1 == \
        js.ask(prompt, stopping_criteria=TextOnlyKeywords())
    assert ts.ask(round2) == ref2 == js.ask(round2)
    _same_state(ts, ref_session)
    _same_state(ts, js)


def test_ask_zero_max_new_tokens_is_noop():
    """max_new_tokens=0 emits and persists nothing after the chunk; the
    session stays usable."""
    pair = Pair(_cfg(), seed=7, max_new=8, chunk=4)
    rng = np.random.default_rng(7)
    prompt = rng.integers(3, pair.cfg.text.vocab_size, size=(6,))
    round2 = rng.integers(3, pair.cfg.text.vocab_size, size=(3,))
    ref_session = TChat(pair.tgen, max_new_tokens_total=96)
    ref_session._start_round(prompt, None)
    js, ts = pair.sessions()
    assert ts.ask(prompt, max_new_tokens=0) == [] == js.ask(prompt, max_new_tokens=0)
    _same_state(ts, ref_session)
    out2 = ts.ask(round2, max_new_tokens=3)
    assert len(out2) == 3 and out2 == js.ask(round2, max_new_tokens=3)
    _same_state(ts, js)


def test_chunked_respects_max_new_exactly():
    """A limit that is not a multiple of the chunk freezes the sample in
    mid-chunk: emitted count and cache lengths are exact."""
    pair = Pair(_cfg(), seed=5, max_new=7, chunk=4)
    prompt = np.random.default_rng(5).integers(3, pair.cfg.text.vocab_size, size=(6,))
    ref, ref_session = _tokenwise(pair.tgen, prompt)
    js, ts = pair.sessions()
    out = ts.ask(prompt)
    assert out == ref[0] == js.ask(prompt) and len(out) == 7
    _same_state(ts, ref_session)
    _same_state(ts, js)


# --- three rounds, sparse and dense, bf16 and int8 KV --------------------------

SPARSE = LlavaConfig.tiny(sparse=dataclasses.replace(
    LlavaConfig.tiny().sparse, use_instruct_predictor=True))
DENSE = _cfg()


def _rounds(cfg, seed):
    rng = np.random.default_rng(seed)
    prompt = np.concatenate([rng.integers(3, 500, 5), [IMAGE_TOKEN_INDEX],
                             rng.integers(3, 500, 7)])
    size = cfg.vision.image_size
    pix = rng.normal(size=(1, size, size, 3)).astype(np.float32)
    return [(prompt, pix), (rng.integers(3, 500, 6), None), (rng.integers(3, 500, 11), None)]


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
@pytest.mark.parametrize("cfg", [SPARSE, DENSE], ids=["sparse", "dense"])
def test_three_round_greedy_chat_is_token_exact(cfg, cache):
    """Round 1: an image and 12 text tokens; rounds 2 and 3: chunks of 6 and
    11 tokens; 10 new tokens a round under a keyword stop that does not
    fire. Tokens equal, tier lengths and next_pos equal after every round;
    the sparse rounds pruned (the post tier shorter than the pre tier)."""
    pair = Pair(cfg, seed=2, max_new=10, chunk=4, cache_dtype=cache)
    js, ts = pair.sessions(total=64)
    crit = FakeKeywords([10**6, 10**6])
    for ids, pix in _rounds(cfg, 2):
        out = ts.ask(ids, pix, stopping_criteria=crit)
        assert out == js.ask(ids, pix, stopping_criteria=crit)
        assert len(out) == 10
        _same_state(ts, js, logits=cache != "int8")
        np.testing.assert_array_equal(ts.cache_lengths(), js.cache_lengths())
    pre, post, _ = _lengths(ts)
    if cfg is SPARSE:
        assert post[-1, 0] < pre[0, 0]
    assert isinstance(ts.runner, StopDecodeRunner)


def test_ring_overflow_is_refused():
    pair = Pair(_cfg(), kv_overflow="ring", kv_window=4)
    with pytest.raises(ValueError, match="kv_overflow='drop'"):
        TChat(pair.tgen)
    with pytest.raises(ValueError, match="kv_overflow='drop'"):
        JChat(pair.jgen)


def test_a_chunk_past_the_pre_tier_room_is_refused():
    """With room for 8 new tokens (and the margin), a 40-token chunk raises,
    as in the JAX session, and leaves the state as it was."""
    pair = Pair(_cfg(), pad_multiple=1, max_new=4)
    rng = np.random.default_rng(8)
    prompt = rng.integers(3, pair.cfg.text.vocab_size, size=(6,))
    js, ts = pair.sessions(total=8)
    ts.ask(prompt)
    js.ask(prompt)
    before = _lengths(ts)
    big = rng.integers(3, pair.cfg.text.vocab_size, size=(40,))
    for session in (ts, js):
        with pytest.raises(ValueError, match="exceeds remaining cache capacity"):
            session.ask(big)
    after = _lengths(ts)
    assert all(np.array_equal(x, y) for x, y in zip(before, after))


def test_generate_between_rounds_leaves_the_session_alone():
    """The session owns its runner: a ``generate`` of other prompts between
    two rounds neither replaces nor overwrites its cache; round 2 equals that of a session without the
    call, and the JAX session's. New stop sequences in round 3 capture a new
    step on the same buffers."""
    pair = Pair(_cfg(), max_new=6, chunk=3)
    rng = np.random.default_rng(9)
    prompt = rng.integers(3, pair.cfg.text.vocab_size, size=(8,))
    round2 = rng.integers(3, pair.cfg.text.vocab_size, size=(5,))
    round3 = rng.integers(3, pair.cfg.text.vocab_size, size=(4,))
    js, ts = pair.sessions()
    _, quiet = pair.sessions()
    assert ts.ask(prompt) == quiet.ask(prompt) == js.ask(prompt)
    runner, cache_k = ts.runner, ts.state.cache.pre.k
    others = [rng.integers(3, pair.cfg.text.vocab_size, size=(8,)) for _ in range(2)]
    pair.tgen.generate(others)
    assert pair.tgen.decode_runner is not None and pair.tgen.decode_runner is not runner
    assert pair.tgen.decode_runner.state.cache.pre.k is not cache_k
    assert ts.ask(round2) == quiet.ask(round2) == js.ask(round2)
    assert ts.runner is runner
    _same_state(ts, quiet)
    stop = [[10**6]]
    assert ts.ask(round3, stop_sequences=stop) == js.ask(round3, stop_sequences=stop)
    assert ts.runner is not runner and ts.state.cache.pre.k is cache_k
    assert ts.runner.key.stop == ((pair.tgen.gen_cfg.eos_token_id,), (10**6,))
    _same_state(ts, js)


def test_a_round_past_the_decode_room_is_refused():
    """The pre tier persists every token: a round whose chunk and new
    tokens pass its room raises before anything is processed (a decode step
    past the capacity would write out of bounds; the JAX session clamps that
    write to the last slot and runs on). Round 1 is checked before its
    prefill."""
    pair = Pair(_cfg(), pad_multiple=1, max_new=4)
    rng = np.random.default_rng(10)
    prompt = rng.integers(3, pair.cfg.text.vocab_size, size=(6,))
    ts = TChat(pair.tgen, max_new_tokens_total=12)  # room 12 + 8 - 1 after the prompt
    with pytest.raises(ValueError, match="new tokens exceed remaining cache capacity 19"):
        ts.ask(prompt, max_new_tokens=20)
    assert ts.state is None and ts._hist == []
    assert len(ts.ask(prompt, max_new_tokens=15)) == 15
    before = _lengths(ts)
    with pytest.raises(ValueError, match="1 chunk tokens and 4 new tokens exceed remaining "
                                         "cache capacity 4"):
        ts.ask(rng.integers(3, pair.cfg.text.vocab_size, size=(1,)))
    assert all(np.array_equal(x, y) for x, y in zip(before, _lengths(ts)))


def test_a_negative_eos_never_stops_the_port():
    """An EOS id of -1 (no token has it) never stops the port's session,
    which pads its stop matrix by position; the JAX session marks padding
    with -1 and so stops at the first token."""
    pair = Pair(_cfg(), eos=-1, max_new=6, chunk=4)
    prompt = np.random.default_rng(11).integers(3, pair.cfg.text.vocab_size, size=(7,))
    js, ts = pair.sessions()
    ref, _ = _tokenwise(pair.tgen, prompt)
    assert ts.ask(prompt) == ref[0] and len(ref[0]) == 6
    assert len(js.ask(prompt)) == 1
