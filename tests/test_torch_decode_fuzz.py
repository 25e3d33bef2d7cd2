"""Randomized equivalence of the port's decode runners, in the manner of
``tests/test_decode_fuzz.py``, on shared (bridged) weights, fp32, tiny
config: random ``SparseConfig`` draws (predictors on / off, keep rates,
the sparse layer), batches mixing image and text-only samples, chunk sizes
and budgets, every KV storage type, drop and ring modes.

* ``Generator.generate``: the port's chunked runner equals its chunk-1
  runner and the JAX ``Generator``, token for token.
* ``ChatSession``: random rounds (2-4, chunks of 2-9 tokens, 0-12 new
  tokens), with a reachable EOS, a keyword stop or ``stop_sequences``:
  answers and ``cache_lengths`` equal the JAX session's after every round.
* ``generate_speculative`` (random draft_k, random or prompt-lookup
  drafts) and ``generate_speculative_device`` (a random
  ``ROUNDS_PER_CHUNK``) equal plain greedy, drop mode.

The draws are few: each test file of the port stays near a minute on one
CPU worker.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from dynamic_llava_tpu.config import LlavaConfig, SparseConfig
from dynamic_llava_tpu.generation.generate import ChatSession as JChat
from dynamic_llava_tpu.generation.generate import GenerationConfig as JGenCfg
from dynamic_llava_tpu.generation.generate import Generator as JGen
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu_torch.generation import speculative
from dynamic_llava_tpu_torch.generation.generate import ChatSession as TChat
from dynamic_llava_tpu_torch.generation.generate import GenerationConfig as TGenCfg
from dynamic_llava_tpu_torch.generation.generate import Generator as TGen
from dynamic_llava_tpu_torch.weights import params_from_numpy

from test_torch_config import port_config

_jinit = jax.jit(jdyn.init_llava_params, static_argnums=(1,))
CACHE_DTYPES = ["bfloat16", "int8", "float8_e4m3fn"]


def _random_cfg(rng: np.random.Generator) -> LlavaConfig:
    sparse = SparseConfig(
        d_model=32, nhead=2, dim_feedforward=64, num_layers=1,
        use_vision_predictor=bool(rng.integers(2)),
        use_text_predictor=False,  # prefill-train-only knob
        use_output_text_predictor=bool(rng.integers(2)),
        use_instruct_predictor=bool(rng.integers(2)),
        vision_keep_rate=float(rng.choice([0.2, 0.5, 0.9])),
        output_text_keep_rate=float(rng.choice([0.3, 0.5, 1.0])),
        sparse_layer=int(rng.choice([1, 2, 3])),
    )
    return LlavaConfig.tiny(sparse=sparse)


def _random_batch(rng, cfg, with_image):
    lens = rng.integers(6, 20, size=int(rng.integers(1, 4)))
    ids_list = []
    for n in lens:
        ids = rng.integers(3, cfg.text.vocab_size, size=(int(n),)).astype(np.int64)
        if with_image:
            ids[min(2, n - 1)] = -200
        ids_list.append(ids)
    imgs = None
    if with_image:
        imgs = rng.normal(
            size=(len(lens), cfg.vision.image_size, cfg.vision.image_size, 3)
        ).astype(np.float32)
    return ids_list, imgs


def _weights(cfg, seed):
    jp = _jinit(jax.random.key(seed), cfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


def _describe(cfg, **kw):
    return f"sparse {dataclasses.asdict(cfg.sparse)} {kw}"


# (draw, overflow mode): ring draws wrap both tiers (a decode window of 4)
GENERATE_DRAWS = [(0, "drop"), (1, "drop"), (2, "ring"), (3, "ring")]


@pytest.mark.parametrize("draw,mode", GENERATE_DRAWS)
def test_generate_matches_jax_random_config(draw, mode):
    rng = np.random.default_rng(500 + draw)
    cfg = _random_cfg(rng)
    jp, tp = _weights(cfg, 30 + draw)
    with_image = bool(rng.integers(2)) or cfg.sparse.use_vision_predictor
    ids_list, imgs = _random_batch(rng, cfg, with_image)
    chunk = int(rng.choice([2, 3, 4, 7]))
    gen = dict(max_new_tokens=int(rng.choice([5, 9, 16])) if mode == "drop" else 20,
               eos_token_id=cfg.text.vocab_size + 7,  # unreachable: the full budget
               bound_kv_budget=bool(rng.integers(2)),
               cache_dtype=str(rng.choice(CACHE_DTYPES)))
    if mode == "ring":
        gen.update(kv_overflow="ring", kv_window=4, pad_multiple=1)
    tcfg = port_config(cfg)
    chunked = TGen(tp, tcfg, TGenCfg(decode_chunk=chunk, **gen)).generate(ids_list, imgs)
    per_token = TGen(tp, tcfg, TGenCfg(decode_chunk=1, **gen)).generate(ids_list, imgs)
    want = JGen(jp, cfg, JGenCfg(decode_chunk=chunk, **gen)).generate(ids_list, imgs)
    what = _describe(cfg, chunk=chunk, **gen)
    assert chunked == per_token, f"draw {draw}: chunked != per-token for {what}"
    assert chunked == [[int(t) for t in o] for o in want], f"draw {draw}: port != JAX for {what}"


class Keywords:
    """A ``KeywordsStoppingCriteria``-shaped criteria: token sequences."""

    def __init__(self, seq):
        self.keyword_ids = [list(seq)]

    def __call__(self, out):
        n = len(self.keyword_ids[0])
        return len(out) >= n and list(out[-n:]) == self.keyword_ids[0]


@pytest.mark.parametrize("draw", range(3))
def test_chat_session_matches_jax_random_rounds(draw):
    rng = np.random.default_rng(700 + draw)
    cfg = _random_cfg(rng)
    jp, tp = _weights(cfg, 40 + draw)
    vocab = cfg.text.vocab_size
    gen = dict(max_new_tokens=8, decode_chunk=int(rng.choice([2, 3, 5])),
               cache_dtype=str(rng.choice(CACHE_DTYPES)), eos_token_id=vocab + 7)
    with_image = cfg.sparse.use_vision_predictor or bool(rng.integers(2))
    prompt, imgs = _random_batch(rng, cfg, with_image)
    rounds = [(prompt[0], None if imgs is None else imgs[:1])] + [
        (rng.integers(3, vocab, int(rng.integers(2, 10))), None)
        for _ in range(int(rng.integers(1, 4)))]
    # a token the model emits in its first round becomes EOS for some draws
    probe = TChat(TGen(tp, port_config(cfg), TGenCfg(**gen)), 128)
    first = probe.ask(*rounds[0], max_new_tokens=12)
    if rng.integers(2):
        gen["eos_token_id"] = int(first[int(rng.integers(len(first)))])
    jsession = JChat(JGen(jp, cfg, JGenCfg(**gen)), max_new_tokens_total=128)
    tsession = TChat(TGen(tp, port_config(cfg), TGenCfg(**gen)), 128)
    for r, (ids, pix) in enumerate(rounds):
        max_new = int(rng.integers(0, 13))
        kind = int(rng.integers(3))
        kw = dict(max_new_tokens=max_new)
        if kind == 1 and len(first) >= 2:
            kw["stopping_criteria"] = Keywords(first[:2] if r == 0 else first[1:3])
        elif kind == 2:
            kw["stop_sequences"] = [[int(t) for t in rng.choice(first, 1)]]
        got = tsession.ask(ids, pix, **kw)
        want = jsession.ask(ids, pix, **kw)
        what = _describe(cfg, round=r, kind=kind, **gen)
        assert got == [int(t) for t in want], f"draw {draw} round {r}: answers for {what}"
        np.testing.assert_array_equal(tsession.cache_lengths(),
                                      np.asarray(jsession.cache_lengths()),
                                      err_msg=f"draw {draw} round {r}: lengths for {what}")


@pytest.mark.parametrize("draw", range(3))
def test_speculative_matches_greedy_random_config(draw, monkeypatch):
    rng = np.random.default_rng(900 + draw)
    jcfg = _random_cfg(rng)
    _, tp = _weights(jcfg, 50 + draw)
    cfg = port_config(jcfg)
    with_image = bool(rng.integers(2)) or cfg.sparse.use_vision_predictor
    ids_list, imgs = _random_batch(rng, cfg, with_image)
    gen = TGen(tp, cfg, TGenCfg(
        max_new_tokens=int(rng.choice([5, 9, 16])), decode_chunk=int(rng.choice([2, 4, 7])),
        eos_token_id=cfg.text.vocab_size + 7, bound_kv_budget=bool(rng.integers(2)),
        cache_dtype=str(rng.choice(CACHE_DTYPES)), pad_multiple=int(rng.choice([1, 8]))))
    ref = gen.generate(ids_list, imgs)
    k = int(rng.integers(1, 7))
    vocab = cfg.text.vocab_size

    def random_draft(ctx, n):
        r = np.random.default_rng(len(ctx))
        return [int(t) for t in r.integers(3, vocab, size=int(r.integers(0, n + 1)))]

    draft = random_draft if rng.integers(2) else "prompt_lookup"
    what = _describe(cfg, k=k, draft=draft, gen=gen.gen_cfg)
    assert gen.generate_speculative(ids_list, imgs, draft=draft, draft_k=k) == ref, what
    monkeypatch.setattr(speculative, "ROUNDS_PER_CHUNK", int(rng.integers(1, 6)))
    assert gen.generate_speculative_device(ids_list, imgs, draft_k=k) == ref, what
