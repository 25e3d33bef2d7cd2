"""The training forward of the port against the JAX package, on the CPU at
a tiny size (4 decoder layers, sparse layer 2, fp32): ``run_layers_nocache``
(remat off and ``"nothing"``), every field of ``forward_train`` on shared
Gumbel noise, the losses, the optimizer's labels and the schedules.

The JAX functions run their plain XLA paths here (their flash dispatch is
off away from a TPU); the port's CPU tensors go through the autograd
ops of K1/K3 and K4 with the plain versions inside. Tolerances:
atol 1e-5 / rtol 1e-4 for activations, 2e-5 / 2e-4 for gradients that
pass through four layers.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import (
    DENSE_SPARSE_CONFIG, ClipVisionConfig, LlamaConfig, LlavaConfig, SparseConfig)
from dynamic_llava_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu.models import llama as jllama
from dynamic_llava_tpu.multimodal.fusion import plan_batch
from dynamic_llava_tpu.train import losses as jlosses
from dynamic_llava_tpu.train import optimizer as jopt
from dynamic_llava_tpu.train import step as jstep
from dynamic_llava_tpu_torch.models import dynamic as tdyn
from dynamic_llava_tpu_torch.models import llama as tllama
from dynamic_llava_tpu_torch.train import losses as tlosses
from dynamic_llava_tpu_torch.train import optimizer as topt
from dynamic_llava_tpu_torch.train import step as tstep
from dynamic_llava_tpu_torch.weights import named_leaves, params_from_numpy

from test_torch_config import port_config
from test_torch_train_ops import jax_uniform

ATOL, RTOL = 1e-5, 1e-4
GATOL, GRTOL = 2e-5, 2e-4

SPARSE = dict(d_model=32, nhead=2, dim_feedforward=64, num_layers=1,
              output_text_len_for_training=8, instruct_len_for_training=4)
CONFIGS = {
    "default": SparseConfig(**SPARSE),  # vision + output text
    "all": SparseConfig(use_instruct_predictor=True, **SPARSE),
    "dense": DENSE_SPARSE_CONFIG,
}


USER_TOKENS = (7, 8)  # stands in for the tokenized "USER:" inside the tiny vocab


def make_cfg(name):
    return LlavaConfig(text=LlamaConfig.tiny(num_key_value_heads=2),
                       vision=ClipVisionConfig.tiny(), sparse=CONFIGS[name])


def make_params(cfg, seed=0):
    """(numpy tree, torch tree) of the same random weights."""
    init = jax.jit(jdyn.init_llava_params, static_argnums=(1,))
    jp = jax.tree.map(np.asarray, init(jax.random.key(seed), cfg))
    return jp, params_from_numpy(jp, "cpu", torch.float32)


def make_batch(cfg, seed=0, b=3, planner=plan_batch):
    """A mixed batch: image samples and one text-only sample, half of each
    row supervised, a "USER:" marker so the instruct span exists."""
    rng = np.random.default_rng(seed)
    ids, labels = [], []
    for i in range(b):
        n = 36 + 5 * i
        row = rng.integers(3, 500, size=(n,)).astype(np.int64)
        if i != 1:
            row[2] = IMAGE_TOKEN_INDEX
        row[8:10] = USER_TOKENS
        lab = row.copy()
        lab[: n // 2] = IGNORE_INDEX
        ids.append(row)
        labels.append(lab)
    plan = planner(ids, cfg.num_image_tokens, labels_list=labels, user_tokens=USER_TOKENS)
    size = cfg.vision.image_size
    images = rng.normal(size=(b, size, size, 3)).astype(np.float32)
    return plan, images


def shared_noise(cfg, key, b, s):
    """The three uniform draws ``forward_train`` of the JAX package makes
    from ``key``, as torch tensors."""
    keys = jax.random.split(key, 3)
    shapes = [(b, cfg.num_image_tokens, 2), (b, s, 2), (b, s, 2)]
    return [torch.from_numpy(np.array(jax_uniform(k, sh))) for k, sh in zip(keys, shapes)]


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


@pytest.fixture(scope="module", params=list(CONFIGS))
def setup(request):
    cfg = make_cfg(request.param)
    jp, tp = make_params(cfg)
    plan, images = make_batch(cfg)
    return request.param, cfg, jp, tp, plan, images


# -- run_layers_nocache ------------------------------------------------------------


@pytest.mark.parametrize("with_policy", [False, True])
def test_run_layers_nocache_matches_jax_with_and_without_remat(with_policy):
    cfg = make_cfg("default")
    jp, tp = make_params(cfg)
    b, s = 2, 19
    rng = np.random.default_rng(1)
    x = rng.normal(size=(b, s, cfg.text.hidden_size)).astype(np.float32)
    pol = rng.uniform(0, 1, (b, s)).astype(np.float32) if with_policy else None
    cot = rng.normal(size=x.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))

    def jfn(llm, x_, pol_):
        return jllama.run_layers_nocache(
            llm, cfg.text, x_, jnp.asarray(pos), lo=1, hi=4, policy=pol_,
            remat=True, training=True)

    @jax.jit  # one compile, not one an op and shape
    def forward_and_grads(llm, x_, pol_, cot_):
        out, vjp = jax.vjp(jfn, llm, x_, pol_)
        return out, vjp(cot_)

    want, (jg_llm, jg_x, jg_pol) = forward_and_grads(
        jp["llm"], jnp.asarray(x), None if pol is None else jnp.asarray(pol), jnp.asarray(cot))

    tcfg = port_config(cfg.text)
    outs = []
    for remat in (False, True):
        llm = {k: v.clone().requires_grad_(True) if torch.is_tensor(v) else
               {n: w.clone().requires_grad_(True) for n, w in v.items()}
               for k, v in tp["llm"].items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        tpol = None if pol is None else torch.from_numpy(pol).requires_grad_(True)
        out = tllama.run_layers_nocache(
            llm, tcfg, tx, torch.from_numpy(pos.copy()), lo=1, hi=4, policy=tpol,
            remat=remat, remat_policy="nothing")
        out.backward(torch.from_numpy(cot))
        _close(out, want)
        _close(tx.grad, jg_x, GATOL, GRTOL)
        if tpol is not None:
            _close(tpol.grad, jg_pol, GATOL, GRTOL)
        for name, w in llm["layers"].items():
            _close(w.grad, jg_llm["layers"][name], GATOL, GRTOL)
        outs.append((out.detach(), tx.grad, {n: w.grad for n, w in llm["layers"].items()}))
    # remat recomputes the same arithmetic: equal outputs and grads
    (o0, gx0, gw0), (o1, gx1, gw1) = outs
    assert torch.equal(o0, o1) and torch.equal(gx0, gx1)
    assert all(torch.equal(gw0[n], gw1[n]) for n in gw0)


def test_run_layers_nocache_rejects_other_remat_policies():
    """An unknown policy name raises; the five JAX policies are held in
    ``tests/test_torch_remat_policy.py``."""
    cfg = port_config(make_cfg("dense")).text
    with pytest.raises(ValueError, match="remat_policy"):
        tllama.run_layers_nocache({"layers": {}}, cfg, torch.zeros(1, 2, 64),
                                  torch.zeros(1, 2, dtype=torch.int32),
                                  remat=True, remat_policy="everything")


# -- forward_train -------------------------------------------------------------------


# the JAX forward under one jit (one compile a config and form, not one an
# op and shape), and its result for each ``setup`` config, by (config name,
# return_hidden): the tests of one config share one JAX run a form
_jforward = jax.jit(jdyn.forward_train, static_argnums=(1,), static_argnames=("return_hidden",))
_JAX_FORWARD = {}


def _forward_both(cfg, jp, tp, plan, images, return_hidden, tau=0.7, seed=5, memo=None):
    """The port's and the JAX package's ``forward_train`` on the same batch
    and noise; ``memo`` (the ``setup`` config's name) keeps the JAX run for
    the next test of that config."""
    jb = jstep.batch_from_plan(plan, images)
    tb = tstep.batch_from_plan(plan, images, "cpu")
    key = jax.random.key(seed)
    want = _JAX_FORWARD.get((memo, return_hidden)) if memo is not None else None
    if want is None:
        want = _jforward(
            jp, cfg, jb.token_ids, jb.is_image, jb.image_slot, jb.valid_len,
            jb.image_start, jb.answer_start, jb.answer_end, jb.last_instruct_start,
            jb.last_instruct_end, jb.has_image, jb.pixel_values, key, jnp.float32(tau),
            return_hidden=return_hidden)
        if memo is not None:
            _JAX_FORWARD[memo, return_hidden] = want
    noise = shared_noise(cfg, key, plan.batch, plan.seq_len)
    with torch.no_grad():
        got = tdyn.forward_train(
            tp, port_config(cfg), tb.token_ids, tb.is_image, tb.image_slot, tb.valid_len,
            tb.image_start, tb.answer_start, tb.answer_end, tb.last_instruct_start,
            tb.last_instruct_end, tb.has_image, tb.pixel_values, noise, tau,
            return_hidden=return_hidden)
    return got, want, tb, jb


@pytest.mark.parametrize("return_hidden", [False, True])
def test_forward_train_every_field_matches_jax(setup, return_hidden):
    name, cfg, jp, tp, plan, images = setup
    got, want, _, _ = _forward_both(cfg, jp, tp, plan, images, return_hidden, memo=name)
    assert got._fields == want._fields
    for field in want._fields:
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if w is None:
            continue
        if np.asarray(w).dtype == bool:
            assert g.dtype == torch.bool
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)
        else:
            # logits sum over 64 hidden units after four layers
            _close(g, w, 5e-5, RTOL)
    assert (got.logits is None) == return_hidden and (got.hidden is None) != return_hidden
    if name == "dense":
        assert got.image_mask is None and got.output_text_mask is None
    else:
        # the masks are hard 0/1 (up to the straight-through rounding,
        # 1 + y - y) and really drop something
        assert set(np.unique(got.image_mask.numpy().round(5))) == {0.0, 1.0}
        assert bool(got.answer_span.any()) and bool(got.image_span.any())
        assert not bool(got.image_span[1].any())  # the text-only sample
    if name == "all":
        assert bool(got.instruct_span.any())


def test_forward_train_with_a_generator_is_reproducible():
    cfg = make_cfg("all")
    _, tp = make_params(cfg)
    plan, images = make_batch(cfg)
    tb = tstep.batch_from_plan(plan, images, "cpu")
    outs = []
    for _ in range(2):
        with torch.no_grad():
            outs.append(tdyn.forward_train(
                tp, port_config(cfg), *tb[:3], tb.valid_len, tb.image_start,
                tb.answer_start, tb.answer_end, tb.last_instruct_start,
                tb.last_instruct_end, tb.has_image, tb.pixel_values,
                torch.Generator().manual_seed(3), 1.0, return_hidden=True))
    for a, b in zip(outs[0], outs[1]):
        assert (a is None and b is None) or torch.equal(a, b)


# -- losses ----------------------------------------------------------------------------


def test_total_loss_and_metrics_match_jax(setup):
    name, cfg, jp, tp, plan, images = setup
    for return_hidden in (False, True):
        got, want, tb, jb = _forward_both(cfg, jp, tp, plan, images, return_hidden, memo=name)
        jl, jm = jlosses.total_loss(want, jb.labels, cfg.sparse, llm_params=jp["llm"],
                                    tcfg=cfg.text)
        with torch.no_grad():
            tl, tm = tlosses.total_loss(got, tb.labels, port_config(cfg.sparse),
                                        llm_params=tp["llm"], tcfg=port_config(cfg.text))
        assert list(tm) == list(jm)
        _close(tl, jl, ATOL, RTOL)
        for k in jm:
            _close(tm[k], jm[k], ATOL, RTOL)


def test_text_only_rows_shorter_than_the_image_span_match_jax():
    """ROADMAP C28: a batch of text-only rows shorter than the image span,
    with pixels (the training CLI's collator stacks a zero image for a
    text-only sample). The JAX gather clamps the span past the end and its
    scatter drops it; the port indexed past the end and raised. Every field
    and the losses match."""
    cfg = make_cfg("default")
    jp, tp = make_params(cfg)
    rng = np.random.default_rng(1)
    ids, labels = [], []
    for n in (9, 12):
        row = rng.integers(3, 500, size=(n,)).astype(np.int64)
        lab = row.copy()
        lab[: n // 2] = IGNORE_INDEX
        ids.append(row)
        labels.append(lab)
    plan = plan_batch(ids, cfg.num_image_tokens, labels_list=labels, user_tokens=USER_TOKENS)
    assert plan.seq_len < cfg.num_image_tokens and not plan.spans.has_image.any()
    size = cfg.vision.image_size
    images = np.zeros((2, size, size, 3), np.float32)
    got, want, tb, jb = _forward_both(cfg, jp, tp, plan, images, return_hidden=True)
    for field in want._fields:
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if w is not None:
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                       atol=5e-5, rtol=RTOL, err_msg=field)
    assert not bool(got.image_span.any())
    jl, jm = jlosses.total_loss(want, jb.labels, cfg.sparse, llm_params=jp["llm"],
                                tcfg=cfg.text)
    with torch.no_grad():
        tl, tm = tlosses.total_loss(got, tb.labels, port_config(cfg.sparse),
                                    llm_params=tp["llm"], tcfg=port_config(cfg.text))
    assert list(tm) == list(jm)
    _close(tl, jl, ATOL, RTOL)


@pytest.mark.parametrize("block_s", [7, 16, 256])
def test_blockwise_ce_equals_dense_ce_and_jax(block_s):
    cfg = make_cfg("dense")
    jp, tp = make_params(cfg)
    rng = np.random.default_rng(2)
    b, s = 2, 33
    hidden = rng.normal(size=(b, s, cfg.text.hidden_size)).astype(np.float32)
    labels = rng.integers(0, cfg.text.vocab_size, (b, s)).astype(np.int32)
    labels[0, :9] = IGNORE_INDEX
    labels[1, 20:] = IGNORE_INDEX
    tcfg = port_config(cfg.text)
    th = torch.from_numpy(hidden).requires_grad_(True)
    blockwise = tlosses.lm_cross_entropy_blockwise(
        tp["llm"], tcfg, th, torch.from_numpy(labels), block_s=block_s)
    (g_block,) = torch.autograd.grad(blockwise, th)
    dense = tlosses.lm_cross_entropy(tllama.lm_head(tp["llm"], tcfg, th),
                                     torch.from_numpy(labels))
    (g_dense,) = torch.autograd.grad(dense, th)
    _close(blockwise, dense.detach().numpy(), 1e-6, 1e-6)
    _close(g_block, g_dense.numpy(), 1e-7, 1e-5)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda h: jlosses.lm_cross_entropy_blockwise(
            jp["llm"], cfg.text, h, jnp.asarray(labels), block_s=block_s)))(jnp.asarray(hidden))
    _close(blockwise, jl)
    _close(g_block, jg, 1e-7, 1e-4)
    # all labels ignored: a zero loss, not a division by zero
    none = torch.full((b, s), IGNORE_INDEX, dtype=torch.int32)
    assert float(tlosses.lm_cross_entropy_blockwise(tp["llm"], tcfg, th.detach(), none)) == 0.0


# -- optimizer labels and schedules --------------------------------------------------------

MODES = [{}, {"lora_mode": True}, {"tune_mm_mlp_adapter": True}, {"projector_lr_group": True}]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: next(iter(m), "default"))
def test_label_params_matches_jax_for_every_leaf(mode):
    cfg = make_cfg("all")
    jp, tp = make_params(cfg)
    # adapter leaves, as train.lora attaches them, to reach the lora labels
    for tree, make in ((jp, np.zeros), (tp, torch.zeros)):
        tree["llm"]["layers"]["q_lora"] = {"a": make((4, 64, 2)), "b": make((4, 2, 64)),
                                           "s": make((4,))}
    want = jopt.label_params(jp, **mode)
    got = topt.label_params(tp, **mode)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): v
             for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    tflat = dict(named_leaves(got))
    assert list(tflat) == list(jflat)  # the same paths in the same order
    assert tflat == jflat
    assert "frozen" in tflat.values() and len(set(tflat.values())) >= 3


@pytest.mark.parametrize("total,ratio", [(100, 0.03), (1000, 0.03), (10, 0.03), (40, 0.25)])
def test_schedules_match_optax(total, ratio):
    want = jopt.cosine_with_warmup(2e-4, total, ratio)
    got = topt.cosine_with_warmup(2e-4, total, ratio)
    warmup = max(1, int(total * ratio))
    for step in (0, 1, warmup - 1, warmup, warmup + 1, total // 2, total - 1, total, total + 5):
        # optax evaluates the cosine in fp32: near the end of the decay the
        # difference is a rounding of 1 + cos, 5e-7 of the peak at most
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5, atol=1e-10)
    assert got(0) == 0.0 and got(warmup) == 2e-4
    jtau = jopt.gumbel_tau_schedule(1.0, 0.1, total)
    ttau = topt.gumbel_tau_schedule(1.0, 0.1, total)
    for step in (0, 1, total // 2, total, total + 3):
        np.testing.assert_allclose(ttau(step), float(jtau(step)), rtol=1e-5)
