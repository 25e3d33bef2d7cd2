"""The training slice as a whole, on the CPU at a tiny size (4 decoder
layers, GQA, sparse layer 2, fp32): train steps of the port against the
jitted JAX step from the same parameters, batch, Gumbel noise and tau, and
the ``Trainer`` loop with save and resume.

Tolerances. Losses and ``grad_norm``: rtol 1e-4. Parameters after three
steps: atol 2e-5 with Adam's ``eps`` at 1e-5 for both optimizers. (With
the default 1e-8 a gradient that is rounding noise around zero, 1e-9 say,
still moves its parameter by a full ``lr`` in the direction of the noise's
sign, so two correct implementations differ by 2 lr there. The formula
under test is the same at any eps.)
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.train import optimizer as jopt
from dynamic_llava_tpu.train import step as jstep
from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch as port_plan_batch
from dynamic_llava_tpu_torch.train import optimizer as topt
from dynamic_llava_tpu_torch.train import step as tstep
from dynamic_llava_tpu_torch.train.trainer import Trainer, TrainerConfig
from dynamic_llava_tpu_torch.weights import named_leaves, params_from_numpy, params_to_numpy

from test_torch_config import port_config
from test_torch_train_model import make_batch, make_cfg, make_params, shared_noise

OPT = dict(base_lr=1e-3, predictor_lr=5e-3, weight_decay=0.01, predictor_weight_decay=0.02,
           eps=1e-5, grad_clip=1.0)
TAU = 0.8


def _jax_copy(tree):
    return jax.tree.map(jnp.asarray, tree)  # the JAX step donates its arguments


def _flat(tree):
    return dict(named_leaves(tree))


def _run_both(name, n_steps, accum, mode=None):
    mode = mode or {}
    cfg = make_cfg(name)
    jp, tp = make_params(cfg)
    start = {p: t.clone() for p, t in _flat(tp).items()}
    plan, images = make_batch(cfg, b=4)
    jb = jstep.batch_from_plan(plan, images)
    tb = tstep.batch_from_plan(plan, images, "cpu")

    joptim = jopt.make_optimizer(**OPT, **mode)
    jlabels = jopt.label_params(jp, **mode)
    jfn = jstep.make_train_step(cfg, joptim, remat=True, grad_accum_steps=accum,
                                labels=jlabels)
    jparams, jstate = _jax_copy(jp), joptim.init(_jax_copy(jp))

    toptim = topt.make_optimizer(**OPT, **mode)
    tfn = tstep.make_train_step(port_config(cfg), toptim, remat=True, grad_accum_steps=accum,
                                labels=topt.label_params(tp, **mode))
    tstate = toptim.init(tp)

    micro_b = plan.batch // accum
    for i in range(n_steps):
        key = jax.random.key(100 + i)
        jparams, jstate, jm = jfn(jparams, jstate, jb, key, jnp.float32(TAU))
        if accum == 1:
            noise = shared_noise(cfg, key, plan.batch, plan.seq_len)
        else:
            noise = [shared_noise(cfg, k, micro_b, plan.seq_len)
                     for k in jax.random.split(key, accum)]
        tp, tstate, tm = tfn(tp, tstate, tb, noise, TAU)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i + 1} {k}")
    got = _flat(params_to_numpy(tp))
    want = _flat(jax.tree.map(np.asarray, jparams))
    assert list(got) == list(want)
    labels = _flat(topt.label_params(tp, **mode))
    moved = 0
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=2e-5, rtol=0, err_msg=path)
        if labels[path] == "frozen":
            assert np.array_equal(got[path], start[path].numpy()), path  # bit-identical
        else:
            moved += int(not np.array_equal(got[path], start[path].numpy()))
    return moved, labels, tstate


def test_three_train_steps_match_jax_sparse():
    moved, labels, state = _run_both("default", 3, 1)
    trainable = [p for p, label in labels.items() if label != "frozen"]
    assert moved == len(trainable)  # every trainable leaf moved
    assert state["count"] == 3 and set(state["mu"]) == set(trainable)


def test_three_train_steps_match_jax_all_predictors():
    _run_both("all", 3, 1)


def test_three_train_steps_match_jax_dense():
    _run_both("dense", 3, 1)


def test_train_step_with_grad_accum_matches_jax():
    _run_both("default", 1, 2)


def test_projector_only_step_matches_jax_and_allocates_no_decoder_grads():
    moved, labels, state = _run_both("default", 2, 1, {"tune_mm_mlp_adapter": True})
    assert moved == 4 and all(p.startswith("mm_projector") for p in state["mu"])


def test_gradients_land_in_the_stacked_buffers_and_frozen_leaves_get_none():
    cfg = make_cfg("default")
    _, tp = make_params(cfg)
    plan, images = make_batch(cfg, b=2)
    tb = tstep.batch_from_plan(plan, images, "cpu")
    seen = {}

    class Spy(topt.GroupedAdamW):
        def update(self, params, grads, state):
            seen.update(grads)
            return super().update(params, grads, state)

    opt = topt.make_optimizer(**OPT)
    opt.__class__ = Spy
    fn = tstep.make_train_step(port_config(cfg), opt, labels=topt.label_params(tp))
    fn(tp, opt.init(tp), tb, torch.Generator().manual_seed(0), TAU)
    leaves = _flat(tp)
    assert not any(p.startswith("vision_tower") for p in seen)
    for path, g in seen.items():
        assert g.shape == leaves[path].shape and g.dtype == leaves[path].dtype
    q = seen["llm/layers/q"]
    assert q.shape[0] == 4 and all(float(q[i].abs().sum()) > 0 for i in range(4))
    # the stored parameters stay plain tensors: no graph, no .grad
    assert all(not t.requires_grad and t.grad is None for t in leaves.values())


# -- Trainer ---------------------------------------------------------------------------


def _trainer(tmp_path, name, params, **kw):
    tc = TrainerConfig(output_dir=str(tmp_path / name), num_train_steps=8, logging_steps=1,
                       save_steps=0, learning_rate=1e-3, predictor_lr=5e-3,
                       warmup_ratio=0.25, seed=11, **kw)
    clone = params_from_numpy(params_to_numpy(params), "cpu", torch.float32)
    return Trainer(port_config(make_cfg("default")), clone, tc, device="cpu")


def test_trainer_save_and_resume_equals_an_uninterrupted_run(tmp_path):
    cfg = make_cfg("default")
    _, tp = make_params(cfg)
    # the port's own planner, as a user of the port would call it
    batches = [make_batch(cfg, seed=seed, b=2, planner=port_plan_batch) for seed in range(4)]

    straight = _trainer(tmp_path, "straight", tp)
    m_straight = straight.train(iter(batches))
    assert straight.step == 4 and np.isfinite(m_straight["loss"])
    assert set(m_straight) >= {"loss", "lm_loss", "image_mask_loss", "output_text_mask_loss",
                               "grad_norm", "gumbel_tau", "learning_rate", "predictor_lr",
                               "steps_per_s"}
    lines = (tmp_path / "straight" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 4

    first = _trainer(tmp_path, "resumed", tp)
    first.train(iter(batches[:3]))
    path = first.save()
    assert path.endswith("step_3.pt")
    second = _trainer(tmp_path, "resumed", tp)  # fresh parameters, same output_dir
    assert second.maybe_resume() and second.step == 3
    assert second.opt_state["count"] == 3
    m_resumed = second.train(iter(batches[3:]))
    assert second.step == 4
    assert m_resumed["loss"] == m_straight["loss"]
    assert m_resumed["grad_norm"] == m_straight["grad_norm"]
    for (p, a), (_, b) in zip(named_leaves(second.params), named_leaves(straight.params)):
        assert torch.equal(a, b), p
    for kind in ("mu", "nu"):
        for p in straight.opt_state[kind]:
            assert torch.equal(second.opt_state[kind][p], straight.opt_state[kind][p]), p

    fresh = _trainer(tmp_path, "nothing_saved", tp)
    assert fresh.maybe_resume() is False and fresh.step == 0
    for t in (straight, first, second, fresh):
        t.logger.close()


def test_trainer_stops_at_num_train_steps_and_keeps_three_checkpoints(tmp_path):
    cfg = make_cfg("default")
    _, tp = make_params(cfg)
    plan, images = make_batch(cfg, b=2)
    tr = _trainer(tmp_path, "ckpts", tp)
    tr.tc.save_steps = 1
    tr.tc.num_train_steps = 5
    tr.train(iter([(plan, images)] * 9))
    assert tr.step == 5
    names = sorted(p.name for p in (tmp_path / "ckpts" / "ckpt").iterdir())
    assert names == ["step_3.pt", "step_4.pt", "step_5.pt"]
    tr.logger.close()


def test_trainer_defaults_to_the_card():
    cfg = make_cfg("dense")
    _, tp = make_params(cfg)
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a card")
    with pytest.raises((AssertionError, RuntimeError)):
        Trainer(port_config(cfg), tp, TrainerConfig(report_to="none"))
