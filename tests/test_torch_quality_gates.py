"""The quality gates on the port (``dynamic_llava_tpu_torch/run/``) against the
JAX harnesses (``run/sparse_quality.py``, ``run/text_sparse_quality.py``,
``run/quant_quality.py``), on the CPU.

Fast cases (Tier-1):
- ``build_corpus`` of each harness gives the JAX harness's arrays for a
  seed (bit for bit);
- ``score_pope`` gives JAX's metrics on the harness's answer texts;
- ``eval_arm`` on bridged JAX weights gives the JAX row: the learned and
  the random arm with the same override scores (or keep decisions). The
  rows are rounded to 4 decimals by both harnesses; PPL and margin agree
  within atol 2e-4 + rtol 1e-4 (fp32 arithmetic through two packages,
  then the rounding), the discrete metrics (accuracy, F1, kept shares)
  exactly;
- three ``train_sparse`` / ``train_lm`` / ``train_tiny`` steps from
  bridged JAX weights with JAX's Gumbel noise fed in give JAX's last
  ``lm_loss`` within rtol 1e-4 (the train-step tolerance of
  ``tests/test_torch_train_step.py``).

Slow cases (``slow``, like the originals in
``tests/test_sparse_quality_gate.py`` and ``tests/test_train_eval_gate.py``):
the two gates and the train-then-evaluate chain, trained and evaluated on
the port at the JAX configs, held to the JAX thresholds unchanged
(``gate_failures`` of each harness). The port's training is not bit-equal
to JAX's (its noise comes from a ``torch.Generator``, its init from the
port's), so the thresholds are held, not the JAX runs' numbers; the step
counts are stated at each test.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu_torch.eval.eval_pope import score_pope
from dynamic_llava_tpu_torch.run import quant_quality as tqq
from dynamic_llava_tpu_torch.run import sparse_quality as tsq
from dynamic_llava_tpu_torch.run import text_sparse_quality as ttq
from dynamic_llava_tpu_torch.weights import params_from_numpy

from test_torch_config import port_config
from test_torch_train_model import shared_noise

ROOT = Path(__file__).resolve().parent.parent
# the gates' step counts on the port (the JAX tests': 150 / 150 for the
# vision gate, 300 dense + 400 sparse for the text gate)
VISION_STEPS = 150
TEXT_DENSE_STEPS, TEXT_STEPS = 300, 400


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "run" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jsq, jtq, jqq = _load("sparse_quality"), _load("text_sparse_quality"), _load("quant_quality")


def _bridge(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


def _rows_close(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if k in ("holdout_answer_ppl", "answer_margin", "recall_ppl"):
            np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-4, err_msg=k)
        else:
            assert g == w, (k, g, w)


# -- corpora and the scorer -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_vision_corpus_equals_jax(seed):
    got = tsq.build_corpus(12, 70, 14, seed=seed)
    want = jsq.build_corpus(12, 70, 14, seed=seed)
    for g, w in zip(got[:2], want[:2]):
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(g, w))
    for g, w in zip(got[2:4], want[2:4]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[4] == want[4]
    assert tsq.VOCAB == jsq.VOCAB and (tsq.YES, tsq.NO, tsq.EOS) == (jsq.YES, jsq.NO, jsq.EOS)


@pytest.mark.parametrize("k", [2, 4])
def test_text_corpus_equals_jax(k):
    got, want = ttq.build_corpus(10, k, seed=0), jtq.build_corpus(10, k, seed=0)
    for name in ("answers", "lengths", "payload_mask", "filler_mask", "recall_mask", "eos_mask"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert (ttq.VOCAB_SIZE, ttq.SEP, ttq.PROMPT) == (jtq.VOCAB_SIZE, jtq.SEP, jtq.PROMPT)


def test_quant_corpus_equals_jax():
    got, want = tqq.build_corpus(32), jqq.build_corpus(32)
    assert all(np.array_equal(g, w) for g, w in zip(got[0], want[0]))
    assert all(np.array_equal(g, w) for g, w in zip(got[1], want[1]))
    assert got[2] == want[2] and tqq.VOCAB == jqq.VOCAB


def test_score_pope_equals_jax_on_the_harness_answers():
    from dynamic_llava_tpu.eval.eval_pope import score_pope as jscore

    texts = ["yes", "no", "none", "yes", "no", "no", "yes", "none", "signal", "no"]
    labels = ["yes", "no", "no", "no", "yes", "no", "yes", "yes", "no", "no"]
    assert score_pope(texts, labels) == jscore(texts, labels)


# -- eval_arm on bridged weights ------------------------------------------------------


@pytest.fixture(scope="module")
def vision_setup():
    jcfg = jsq.make_cfg(64, 2, 0.2, sparse_layer=0)
    jp = _jinit(jax.random.key(0), jcfg)
    prompts, answers, imgs, sig_pos, labels = jsq.build_corpus(8, 70, 14, seed=1)
    return jcfg, jp, (prompts, answers, imgs, sig_pos, labels)


def _jinit(key, cfg):
    from dynamic_llava_tpu.models import dynamic as jdyn

    return jax.jit(jdyn.init_llava_params, static_argnums=(1, 2))(key, cfg, jnp.float32)


def test_vision_eval_arm_matches_jax(vision_setup):
    jcfg, jp, args = vision_setup
    tp, cfg = _bridge(jp), port_config(jcfg)
    scores = np.random.default_rng(7).uniform(size=(8, jcfg.num_image_tokens))
    for override in (None, scores):  # the learned arm, then the random arm
        want = jsq.eval_arm(jp, jcfg, *args, score_override=override)
        got = tsq.eval_arm(tp, cfg, *args, score_override=override, device="cpu")
        _rows_close(got, want)
        assert got["signal_patch_kept"] is not None


def test_text_eval_arm_matches_jax():
    jcfg = jtq.make_cfg(64, 2, 0)
    jp = _jinit(jax.random.key(0), jcfg)
    tp, cfg = _bridge(jp), port_config(jcfg)
    ho = jtq.build_corpus(6, 2, seed=0)
    t = ho.answers.shape[1]
    override = (np.random.default_rng(7).uniform(size=(t - 1, 6)) < 0.5).astype(np.int32)
    for keep in (None, override):
        want = jtq.eval_arm(jp, jcfg, ho, keep_override=keep)
        got = ttq.eval_arm(tp, cfg, ttq.build_corpus(6, 2, seed=0), keep_override=keep,
                           device="cpu")
        _rows_close(got, want)


# -- training steps with JAX's noise -----------------------------------------------------


def test_train_sparse_steps_match_jax(vision_setup):
    jcfg, jp, _ = vision_setup
    prompts, answers, imgs, _, _ = jsq.build_corpus(4, 70, 14, seed=2)
    tp = _bridge(jp)
    _, want = jsq.train_sparse(jcfg, prompts, answers, imgs, 3,
                               params=jax.tree.map(jnp.asarray, jp))
    s = len(prompts[0]) + 2 - 1 + jcfg.num_image_tokens
    _, got = tsq.train_sparse(
        port_config(jcfg), prompts, answers, imgs, 3, params=tp, device="cpu",
        noise=lambda i: shared_noise(jcfg, jax.random.key(100 + i), 4, s))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_train_lm_steps_match_jax():
    jcfg = jtq.make_cfg(64, 2, 0)
    jp = _jinit(jax.random.key(0), jcfg)
    tp = _bridge(jp)
    _, want = jtq.train_lm(jcfg, 2, 3, batch_size=4, params=jax.tree.map(jnp.asarray, jp))
    s = len(jtq.PROMPT) + jtq.build_corpus(1, 2).answers.shape[1]
    _, got = ttq.train_lm(
        port_config(jcfg), 2, 3, batch_size=4, params=tp, device="cpu",
        noise=lambda i: shared_noise(jcfg, jax.random.key(100 + i), 4, s))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_train_tiny_steps_match_jax():
    from dynamic_llava_tpu.config import (ClipVisionConfig, LlamaConfig, LlavaConfig,
                                          SparseConfig)

    cfg = port_config(tqq.make_cfg())
    jcfg = LlavaConfig(
        text=LlamaConfig(**{f: getattr(cfg.text, f) for f in (
            "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads")}),
        vision=ClipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=2, image_size=70, patch_size=14),
        sparse=SparseConfig(d_model=32, nhead=2, dim_feedforward=64, num_layers=1,
                            use_vision_predictor=False, use_text_predictor=False,
                            use_output_text_predictor=False, use_instruct_predictor=False))
    assert port_config(jcfg) == cfg
    prompts, answers, _ = jqq.build_corpus(8)
    jp = _jinit(jax.random.key(0), jcfg)
    tp = _bridge(jp)
    # the JAX harness draws its own init: train from the same bridged one
    import dynamic_llava_tpu.models.dynamic as jdyn

    real = jdyn.init_llava_params
    jdyn.init_llava_params = lambda key, c, dtype: jax.tree.map(jnp.asarray, jp)
    try:
        _, want = jqq.train_tiny(jcfg, prompts, answers, 3)
    finally:
        jdyn.init_llava_params = real
    s = len(prompts[0]) + 2
    _, got = tqq.train_tiny(cfg, prompts, answers, 3, params=tp, device="cpu",
                            noise=lambda i: shared_noise(jcfg, jax.random.key(100 + i), 8, s))
    np.testing.assert_allclose(got, want, rtol=1e-4)


# -- the gates (slow) --------------------------------------------------------------------


@pytest.mark.slow
def test_learned_pruning_beats_random():
    rows, gaps = tsq.run_all(steps=VISION_STEPS, pairs=32, holdout=32, hidden=64, layers=3,
                             dense_steps=VISION_STEPS, sparse_layer=0, seed=0, device="cpu")
    assert tsq.gate_failures(rows, gaps) == [], (rows, gaps)


@pytest.mark.slow
def test_learned_text_pruning_beats_random():
    rows, gaps = ttq.run_all(steps=TEXT_STEPS, batch=32, holdout=32, hidden=64, layers=3, k=2,
                             sparse_layer=0, seed=0, dense_steps=TEXT_DENSE_STEPS,
                             predictor_lr=6e-3, device="cpu")
    assert ttq.gate_failures(rows, gaps) == [], (rows, gaps)


@pytest.mark.slow
def test_train_then_eval_scores_full_accuracy():
    result = tqq.run_gate(steps=40, device="cpu")
    assert tqq.gate_failures(result) == [], result
