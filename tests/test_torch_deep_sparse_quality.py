"""The production-boundary quality harness on the port
(``dynamic_llava_tpu_torch/run/deep_sparse_quality.py``) against the JAX
harness (``run/deep_sparse_quality.py``), on the CPU at a small config
(hidden 64, 3 layers, sparse_layer 2, one predictor block):

- ``build_corpus`` gives the JAX arrays for a seed, bit for bit, for both
  tile encodings and chain depths 0-2; ``hops_schedule`` and ``make_cfg``
  are the JAX ones;
- three ``train_fresh`` steps of each stage (dense with the progressive
  curriculum; sparse with the depth cycle and the base / predictor lr
  split) from bridged JAX weights, with JAX's Gumbel noise fed in, give
  JAX's last ``lm_loss`` of every depth within rtol 1e-4 (the train-step
  tolerance of ``tests/test_torch_train_step.py``);
- ``eval_arm`` on bridged weights gives the JAX row for the dense, the
  learned and the random arm (the same override scores) at depths 1 and 2:
  PPL within atol 2e-4 + rtol 1e-4 (fp32 through two packages, then the
  rounding to 4 decimals), accuracy, F1 and every ``chain*_kept`` exactly;
- the port's ``run_all`` at the JAX docstring's smoke size (steps, batch,
  holdout; the widths above) prints JAX's rows: the same depths, arms and
  keys;
- ``chip_smoke.deep_quality`` (phase 4c) rehearsed on the CPU at the widths
  above: its card-against-CPU holds pass with the CPU in the card's place,
  and it returns finite rows for depths 1 and 2 with every arm.

The JAX harness has no threshold, and the port's twin adds none.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu_torch.run import deep_sparse_quality as tdq
from dynamic_llava_tpu_torch.weights import params_from_numpy

from test_torch_config import port_config
from test_torch_train_model import shared_noise

ROOT = Path(__file__).resolve().parent.parent
HIDDEN, LAYERS, SPARSE_LAYER, PRED_LAYERS = 64, 3, 2, 1
STEPS, BATCH, HOLDOUT = 3, 4, 8
IMAGE, PATCH = 70, 14


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "run" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jdq = _load("deep_sparse_quality")


def _bridge(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


def _cfgs(make_cfg):
    """(sparse at keep 0.2, dense) configs of one package's ``make_cfg``."""
    return (make_cfg(HIDDEN, LAYERS, 0.2, SPARSE_LAYER, pred_layers=PRED_LAYERS),
            make_cfg(HIDDEN, LAYERS, 1.0, SPARSE_LAYER, use_vision_predictor=False,
                     pred_layers=PRED_LAYERS))


@pytest.fixture(scope="module")
def weights():
    """JAX configs, and numpy trees of JAX weights for the dense stage and (with fresh
    predictors, as ``run_all`` adds them) for the sparse one."""
    from dynamic_llava_tpu.models import dynamic as jdyn
    from dynamic_llava_tpu.models.predictors import init_predictors

    jcfg, jdense = _cfgs(jdq.make_cfg)
    jp = jax.jit(jdyn.init_llava_params, static_argnums=(1, 2))(
        jax.random.key(0), jdense, jnp.float32)
    sparse = dict(jp)
    sparse["predictors"] = init_predictors(jax.random.key(1), jcfg.text, jcfg.sparse,
                                           jnp.float32)
    # numpy trees: the JAX train step donates the arrays it is given
    return jcfg, jdense, jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, sparse)


# -- corpus, schedule, config -------------------------------------------------------------


@pytest.mark.parametrize("hops", [0, 1, 2])
@pytest.mark.parametrize("encoding", ["halves", "additive"])
def test_corpus_equals_jax(encoding, hops):
    kw = dict(seed=3, hops=hops, encoding=encoding)
    got, want = tdq.build_corpus(6, IMAGE, PATCH, **kw), jdq.build_corpus(6, IMAGE, PATCH, **kw)
    for g, w in zip(got[:2], want[:2]):
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(g, w))
    for g, w in zip(got[2:4], want[2:4]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[4] == want[4]
    assert tdq.QUESTION == jdq.QUESTION
    assert (tdq.VOCAB, tdq.YES, tdq.NO, tdq.EOS) == (jdq.VOCAB, jdq.YES, jdq.NO, jdq.EOS)


@pytest.mark.parametrize("steps,max_hops", [(3, 2), (10, 2), (1500, 2), (7, 1), (5, 0)])
def test_hops_schedule_equals_jax(steps, max_hops):
    assert tdq.hops_schedule(steps, max_hops) == jdq.hops_schedule(steps, max_hops)


def test_make_cfg_equals_jax():
    for got, want in zip(_cfgs(tdq.make_cfg), _cfgs(jdq.make_cfg)):
        assert got == port_config(want)
    assert tdq.make_cfg(128, 8, 0.5, 2) == port_config(jdq.make_cfg(128, 8, 0.5, 2))


# -- training steps with JAX's noise ---------------------------------------------------------


@pytest.mark.parametrize("stage", ["dense", "sparse"])
def test_train_fresh_steps_match_jax(weights, stage):
    jcfg, jdense, jp_dense, jp_sparse = weights
    cfg, jp = (jdense, jp_dense) if stage == "dense" else (jcfg, jp_sparse)
    # dense: the progressive curriculum at one lr; sparse: the depth cycle,
    # the base at run_all's stage-2 lr and the predictors at 3e-3
    kw = (dict(curriculum=True) if stage == "dense"
          else dict(curriculum="cycle", base_lr=7.5e-5))
    seed = 0 if stage == "dense" else 1
    _, want = jdq.train_fresh(cfg, STEPS, BATCH, seed, IMAGE, PATCH, 2,
                              params=jax.tree.map(jnp.asarray, jp), **kw)
    s = len(jdq.QUESTION) + 2 - 1 + cfg.num_image_tokens
    _, got = tdq.train_fresh(
        port_config(cfg), STEPS, BATCH, seed, IMAGE, PATCH, 2, params=_bridge(jp),
        device="cpu", noise=lambda i: shared_noise(cfg, jax.random.key(100 + i), BATCH, s),
        **kw)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for h in want:
        np.testing.assert_allclose(got[h], want[h], rtol=1e-4, err_msg=f"depth {h}")


# -- eval_arm on bridged weights --------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_rows(weights):
    """JAX's rows of the dense, learned@0.2 and random@0.2 arms at depths 1
    and 2 on the sparse stage's weights, with the held-out sets and
    override scores that gave them."""
    jcfg, jdense, _, jp = weights
    rng = np.random.default_rng(7)
    out = {}
    for h in (1, 2):
        ho = jdq.build_corpus(HOLDOUT, IMAGE, PATCH, seed=999_999 + h, hops=h)
        scores = rng.uniform(size=(HOLDOUT, jcfg.num_image_tokens))
        out[h] = dict(ho=ho, scores=scores, rows={
            "dense": jdq.eval_arm(jp, jdense, *ho),
            "learned@0.2": jdq.eval_arm(jp, jcfg, *ho),
            "random@0.2": jdq.eval_arm(jp, jcfg, *ho, score_override=scores),
        })
    return out


def _rows_close(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        if k == "holdout_answer_ppl":
            np.testing.assert_allclose(got[k], w, atol=2e-4, rtol=1e-4, err_msg=k)
        else:
            assert got[k] == w, (k, got[k], w)


@pytest.mark.parametrize("hops", [1, 2])
def test_eval_arm_matches_jax(weights, jax_rows, hops):
    jcfg, jdense, _, jp = weights
    tp = _bridge(jp)
    ref = jax_rows[hops]
    arms = {"dense": (jdense, None), "learned@0.2": (jcfg, None),
            "random@0.2": (jcfg, ref["scores"])}
    for name, (cfg, override) in arms.items():
        got = tdq.eval_arm(tp, port_config(cfg), *ref["ho"], score_override=override,
                           device="cpu")
        _rows_close(got, ref["rows"][name])
    assert "chain_end_kept" in got and f"chain{hops}_kept" in got


# -- the whole run at the smoke size ------------------------------------------------------------


def test_run_all_prints_the_jax_rows(jax_rows, capsys):
    # the JAX docstring's smoke size (--hops 2 --steps 8 --dense-steps 8
    # --batch 8 --holdout 8) at the module's widths, on one CPU thread: the
    # run is thousands of small ops, which more threads only stall when the
    # test workers share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows, gaps = tdq.run_all(8, 8, 8, 8, HIDDEN, LAYERS, SPARSE_LAYER, 2, seed=0,
                                 pred_layers=PRED_LAYERS, device="cpu")
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    arms = ["dense", "learned@0.2", "random@0.2", "learned@0.5", "random@0.5"]
    gap_keys = ["learned_minus_random_acc@0.2", "learned_minus_random_acc@0.5"]
    want = []
    for h in (1, 2):
        keys = {name: list(row) for name, row in jax_rows[h]["rows"].items()}
        for arm in arms:
            like = "dense" if arm == "dense" else "learned@0.2"
            want.append((h, arm, ["hops", "arm"] + keys[like]))
        want.append((h, "gaps", ["hops", "sparse_layer", "gaps"]))
    got = [(ln["hops"], ln.get("arm", "gaps"), list(ln)) for ln in lines]
    assert got == want
    for ln in lines:
        if "gaps" in ln:
            assert list(ln["gaps"]) == gap_keys and ln["sparse_layer"] == 2
            assert ln["gaps"] == gaps[ln["hops"]]
        else:
            assert {k: v for k, v in ln.items() if k not in ("hops", "arm")} == \
                rows[ln["hops"]][ln["arm"]]
            assert all(v is None or np.isfinite(v) for v in ln.values() if v != ln["arm"])


def test_chip_smoke_deep_quality_phase_on_the_cpu():
    """Phase 4c's function with the CPU in the card's place, at the module's
    widths and a few steps, on one thread (as ``run_all`` above): both sides
    of each hold are the CPU's, so they agree exactly; the wrapper counters
    stay at 0 (they count launches on the card only)."""
    import chip_smoke

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = chip_smoke.deep_quality(torch, device="cpu", sizes=dict(
            hidden=HIDDEN, layers=LAYERS, sparse_layer=SPARSE_LAYER, pred_layers=PRED_LAYERS,
            batch=BATCH, holdout=HOLDOUT, hops=2, dense_steps=4, steps=4))
    finally:
        torch.set_num_threads(threads)
    assert r["steps"] == {"dense": 4, "sparse": 4}
    for stage in ("dense", "sparse"):
        held = r["holds"]["train"][stage]
        assert held["card"] == held["cpu"] and sorted(held["cpu"]) == [0, 1, 2]
    assert list(r["holds"]["eval"]) == ["dense", "learned@0.2", "random@0.2"]
    arms = ["dense", "learned@0.2", "random@0.2", "learned@0.5", "random@0.5"]
    assert list(r["rows"]) == ["1", "2"] and all(list(r["rows"][h]) == arms for h in ("1", "2"))
    assert all(np.isfinite(v) for by_arm in r["rows"].values() for row in by_arm.values()
               for v in row.values() if v is not None)
    assert list(r["gaps"]) == ["1", "2"]
    assert r["wrapper_calls"] == {"K1": 0, "K3": 0, "K4": 0, "K2": 0}
