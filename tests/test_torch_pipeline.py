"""The port's GPipe layer runner (``dynamic_llava_tpu_torch/parallel/pipeline.py``)
on 4 gloo ranks over a ``(data, fsdp, tensor, pipe) = (1, 2, 1, 2)`` mesh,
held to the JAX package's SEQUENTIAL path, the cases of
``tests/test_pipeline.py``:

* ``pipe=2``, ``microbatches=2``: the pre and post sweeps for (layers,
  sparse_layer) in (4, 2) and (4, 1) (there stage 1 has no pre layer and
  stage 0 one post layer fewer), forward at 1e-6 against
  ``run_layers_nocache``;
* the post sweep's gradients (remat on) against ``jax.grad`` of the
  sequential layers, at the JAX test's tolerances (rtol 2e-5 / atol 1e-7);
* bf16: the gradients w.r.t. ``x`` and ``q`` against the sequential bf16
  ones, at the JAX test's tolerances (rtol 2e-2 / atol 1e-5 and 5e-2 /
  2e-4);
* a whole pipelined train step against the JAX single-device step (loss at
  rtol 2e-4 / atol 2e-5, the updated ``q`` at rtol 2e-3 / atol 2e-5);
* ``Trainer`` in pipeline mode for 2 steps: ``unpermuted_params`` exactly
  inverts the pipeline order, and a resume restores step 2 and every layer
  and moment bit for bit.

ONE spawn of 4 ranks (``torch_mesh_workers.run_ranks``) runs every case; the
JAX references run here.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dynamic_llava_tpu.config import LlamaConfig
from dynamic_llava_tpu.models import dynamic, llama
from dynamic_llava_tpu.parallel.pipeline import plan_pipeline
from dynamic_llava_tpu.train.optimizer import make_optimizer
from dynamic_llava_tpu.train.step import batch_from_plan, make_train_step

from test_torch_config import port_config
from test_torch_sharding import OPT, _train_cfg, np_noise, np_tree, train_batch
from test_torch_train_model import shared_noise
from torch_mesh_workers import run_ranks

MESH = (1, 2, 1, 2)
WORLD = 4
SWEEPS = [(4, 2), (4, 1)]

# the JAX functions under one jit each: one compile a shape, not one an op
_jinit_llama = jax.jit(llama.init_llama_params, static_argnums=(1, 2))
_jinit_llava = jax.jit(dynamic.init_llava_params, static_argnums=(1,))
_jnocache = jax.jit(llama.run_layers_nocache, static_argnums=(1,),
                    static_argnames=("lo", "hi", "training"))


def _tcfg(layers=4):  # tests/test_pipeline.py
    return LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                       num_hidden_layers=layers, num_attention_heads=4, num_key_value_heads=4)


def _inputs(cfg, b, s, dtype):
    x = np.asarray(jax.random.normal(jax.random.key(1), (b, s, cfg.hidden_size), dtype)
                   .astype(jnp.float32))
    positions = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    policy = np.asarray((jax.random.uniform(jax.random.key(2), (b, s)) > 0.3)
                        .astype(jnp.float32))
    return x, positions, policy


def _seq_grads(params, cfg, x, positions, policy, lo, hi, out_dtype=jnp.float32):
    """``jax.grad`` of ``mean(run_layers_nocache(x)[lo:hi] ** 2)`` w.r.t. the
    layers and ``x``."""
    def loss(layers, xx):
        p = dict(params, layers=layers)
        y = llama.run_layers_nocache(p, cfg, xx, jnp.asarray(positions), lo=lo, hi=hi,
                                     training=True, remat=True, policy=policy)
        return (y.astype(out_dtype) ** 2).mean()
    return jax.jit(jax.grad(loss, argnums=(0, 1)))(params["layers"], x)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on the 4 ranks, and the JAX references (computed while the
    ranks run)."""
    cases, jax_refs = {}, []
    for layers, sl in SWEEPS:
        cfg = _tcfg(layers)
        params = _jinit_llama(jax.random.key(0), cfg, jnp.float32)
        x, positions, policy = _inputs(cfg, 4, 12, jnp.float32)
        cases[f"sweeps_{layers}_{sl}"] = ("sweeps", dict(
            text_cfg=port_config(cfg), params=np_tree(params), x=x, positions=positions,
            policy=policy, layers=layers, sparse_layer=sl, mesh_shape=MESH))

        def sweeps_ref(cfg=cfg, params=params, x=x, positions=positions, policy=policy,
                       layers=layers, sl=sl):
            pre = _jnocache(params, cfg, jnp.asarray(x), jnp.asarray(positions),
                            lo=0, hi=sl, training=True)
            post = _jnocache(params, cfg, pre, jnp.asarray(positions), lo=sl,
                             hi=layers, policy=jnp.asarray(policy), training=True)
            return np.asarray(pre), np.asarray(post)
        jax_refs.append((f"sweeps_{layers}_{sl}", sweeps_ref))

    # gradients of the post sweep: fp32 without a policy (as the JAX test),
    # and bf16 with one
    cfg = _tcfg(4)
    for name, dtype in (("grads", jnp.float32), ("bf16", jnp.bfloat16)):
        params = _jinit_llama(jax.random.key(0), cfg, dtype)
        x, positions, policy = _inputs(cfg, 4, 10, dtype)
        policy = None if name == "grads" else policy
        cases[name] = ("sweeps", dict(
            text_cfg=port_config(cfg), params=np_tree(jax.tree.map(
                lambda a: a.astype(jnp.float32), params)), x=x, positions=positions,
            policy=policy, layers=4, sparse_layer=2, mesh_shape=MESH, cotangent=True,
            dtype=jnp.dtype(dtype).name))

        def grads_ref(params=params, x=x, positions=positions, policy=policy, dtype=dtype):
            g_layers, g_x = _seq_grads(params, cfg, jnp.asarray(x, dtype), positions,
                                       None if policy is None else jnp.asarray(policy), 2, 4)
            return ({k: np.asarray(v.astype(jnp.float32)) for k, v in g_layers.items()},
                    np.asarray(g_x.astype(jnp.float32)))
        jax_refs.append((name, grads_ref))

    # a whole pipelined train step against the single-device JAX step
    lcfg = _train_cfg()
    lparams = np_tree(_jinit_llava(jax.random.key(0), lcfg))
    plan, imgs, _, _ = train_batch(lcfg, 4)
    batch = batch_from_plan(plan, imgs)
    key = jax.random.key(7)
    cases["step"] = ("train_step", dict(
        cfg=port_config(lcfg), params=lparams,
        batch=[None if f is None else np.asarray(f) for f in batch],
        noise=np_noise(shared_noise(lcfg, key, plan.batch, plan.seq_len)), tau=1.0,
        mesh_shape=MESH, opt=OPT, pipe_plan=(2, 2)))

    def step_ref():
        optimizer = make_optimizer(**OPT)
        p1, _, m1 = make_train_step(lcfg, optimizer, remat=False)(
            jax.tree.map(jnp.asarray, lparams),
            optimizer.init(jax.tree.map(jnp.asarray, lparams)), batch, key, jnp.float32(1.0))
        return float(m1["loss"]), np.asarray(p1["llm"]["layers"]["q"])
    jax_refs.append(("step", step_ref))

    # the Trainer in pipeline mode, then a resume
    _, imgs1, ids1, labels1 = train_batch(lcfg, 4, seed=1)
    cases["trainer"] = ("trainer_pipeline", dict(
        cfg=port_config(lcfg), params=lparams, ids=ids1, labels=labels1, images=imgs1,
        mesh_shape=MESH, out_dir=str(tmp_path_factory.mktemp("pipe_trainer"))))

    results, refs = run_ranks(tmp_path_factory.mktemp("mesh4"), WORLD, cases, timeout=400,
                              while_running=lambda: {n: f() for n, f in jax_refs})
    refs["trainer_q"] = lparams["llm"]["layers"]["q"]
    return results, refs


@pytest.mark.parametrize("layers,sl", SWEEPS)
def test_pipeline_sweeps_match_sequential_jax(ranks, layers, sl):
    results, refs = ranks
    pre, post = refs[f"sweeps_{layers}_{sl}"]
    for r, res in enumerate(results):
        got = res[f"sweeps_{layers}_{sl}"]
        np.testing.assert_allclose(got["pre"], pre, rtol=1e-6, atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["post"], post, rtol=1e-6, atol=1e-6, err_msg=f"rank {r}")


def test_pipeline_grads_match_sequential_jax(ranks):
    results, refs = ranks
    g_layers, g_x = refs["grads"]
    for r, res in enumerate(results):
        got = res["grads"]
        for k in ("q", "down", "input_ln"):
            np.testing.assert_allclose(got[k], g_layers[k], rtol=2e-5, atol=1e-7,
                                       err_msg=f"rank {r} {k}")
        np.testing.assert_allclose(got["x"], g_x, rtol=2e-5, atol=1e-7)


def test_pipeline_bf16_grads_match_sequential_jax(ranks):
    results, refs = ranks
    g_layers, g_x = refs["bf16"]
    for res in results:
        got = res["bf16"]
        np.testing.assert_allclose(got["x"], g_x, rtol=2e-2, atol=1e-5)
        np.testing.assert_allclose(got["q"], g_layers["q"], rtol=5e-2, atol=2e-4)


def test_pipelined_train_step_matches_single_device_jax(ranks):
    results, refs = ranks
    loss, q = refs["step"]
    for res in results:
        got = res["step"]
        np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got["q"], q, rtol=2e-3, atol=2e-5)


def test_trainer_pipeline_mode_unpermutes_and_resumes_exactly(ranks):
    results, refs = ranks
    q0 = refs["trainer_q"]
    order = plan_pipeline(4, 2, stages=2, microbatches=2).order
    for r, res in enumerate(results):
        got = res["trainer"]
        assert np.isfinite(got["loss"]), r
        assert tuple(got["order"]) == order
        assert got["unpermuted_q"].shape == q0.shape
        assert got["requeue_exact"], r
        assert not np.array_equal(got["unpermuted_q"], q0)  # the steps trained q
        assert got["resumed"] and got["step2"] == 2
        assert got["same_layers"] == got["layers"] and got["moments_same"], r
