"""The port's remat policies against the JAX package's
(``tests/test_remat_policy.py``), on the CPU at a tiny size (2 layers,
hidden 64, 4 heads, fp32).

Every policy of ``models.llama.run_layers_nocache`` (``nothing``,
``dots``, ``flash``, ``flash_dots``, ``alternate``), with and without a
policy mask, must give the gradients of the run without remat within
2e-5 (they recompute the same arithmetic, so in practice they are equal)
and the JAX package's gradients under the same policy within 2e-5 / rtol
2e-4 (two implementations, the tolerance of
``tests/test_torch_train_model.py``). What a policy saves is counted: the
attention forward op (K1's ``flash_forward``, or K4's
``flash_policy_forward`` under a policy mask) runs once a layer in forward
+ backward under ``flash`` / ``flash_dots`` / ``alternate`` and twice
under ``nothing`` / ``dots``; under ``dots`` the backward runs no weight
product of the forward again.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dynamic_llava_tpu.config import LlamaConfig
from dynamic_llava_tpu.models import llama as jllama
from dynamic_llava_tpu_torch.models import llama as tllama
from dynamic_llava_tpu_torch.ops import flash_attention as tflash
from dynamic_llava_tpu_torch.weights import params_from_numpy

from test_torch_config import port_config

CFG = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4)
TCFG = port_config(CFG)
POLICIES = ("nothing", "dots", "flash", "flash_dots", "alternate")
WEIGHTS = ("q", "k", "v", "o", "gate", "up", "down")


@pytest.fixture(scope="module")
def inputs():
    jp = jax.tree.map(np.asarray, jllama.init_llama_params(jax.random.key(0), CFG, jnp.float32))
    b, s = 2, 32
    rng = np.random.default_rng(1)
    x = rng.normal(size=(b, s, CFG.hidden_size)).astype(np.float32)
    pol = (rng.uniform(size=(b, s)) > 0.3).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    return jp, x, pol, pos


def _jax_grads(jp, x, pol, pos, remat, policy):
    def loss(params, x_):
        y = jllama.run_layers_nocache(
            params, CFG, x_, jnp.asarray(pos), policy=None if pol is None else jnp.asarray(pol),
            remat=remat, remat_policy=policy, training=True)
        return jnp.sum(y * y)

    # under one jit: one compile a policy, not one an op
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    return {n: np.asarray(gp["layers"][n]) for n in WEIGHTS}, np.asarray(gx)


def _port_grads(jp, x, pol, pos, remat, policy):
    tp = params_from_numpy(jp, "cpu", torch.float32)
    layers = {n: w.requires_grad_(True) if n in WEIGHTS else w
              for n, w in tp["layers"].items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tllama.run_layers_nocache(
        {"layers": layers}, TCFG, tx, torch.from_numpy(pos),
        policy=None if pol is None else torch.from_numpy(pol), remat=remat,
        remat_policy=policy)
    (y * y).sum().backward()
    return {n: layers[n].grad.numpy() for n in WEIGHTS}, tx.grad.numpy()


@pytest.mark.parametrize("with_policy", [False, True])
@pytest.mark.parametrize("remat_policy", POLICIES)
def test_remat_grads_match_no_remat_and_jax(inputs, with_policy, remat_policy):
    jp, x, pol, pos = inputs
    pol = pol if with_policy else None
    ref_w, ref_x = _port_grads(jp, x, pol, pos, False, "nothing")
    got_w, got_x = _port_grads(jp, x, pol, pos, True, remat_policy)
    jax_w, jax_x = _jax_grads(jp, x, pol, pos, True, remat_policy)
    np.testing.assert_allclose(got_x, ref_x, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_x, jax_x, rtol=2e-4, atol=2e-5)
    for n in WEIGHTS:
        assert np.abs(ref_w[n]).max() > 1e-3, n
        np.testing.assert_allclose(got_w[n], ref_w[n], rtol=2e-5, atol=2e-5, err_msg=n)
        np.testing.assert_allclose(got_w[n], jax_w[n], rtol=2e-4, atol=2e-5, err_msg=n)


class _CountMm(TorchDispatchMode):
    """Counts the weight products (``mm``) that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _counts(inputs, with_policy, remat, policy):
    """(attention forward runs in forward + backward, weight products in
    the backward)."""
    jp, x, pol, pos = inputs
    tp = params_from_numpy(jp, "cpu", torch.float32)
    layers = {n: w.requires_grad_(n in WEIGHTS) for n, w in tp["layers"].items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    key = "flash_policy_forward" if with_policy else "flash_forward"
    runs0 = tflash.OP_RUNS[key]
    y = tllama.run_layers_nocache(
        {"layers": layers}, TCFG, tx, torch.from_numpy(pos),
        policy=torch.from_numpy(pol) if with_policy else None, remat=remat,
        remat_policy=policy)
    with _CountMm() as mode:
        (y * y).sum().backward()
    return tflash.OP_RUNS[key] - runs0, mode.mm


@pytest.mark.parametrize("with_policy", [False, True])
@pytest.mark.parametrize("remat_policy", POLICIES)
def test_what_each_policy_recomputes(inputs, with_policy, remat_policy):
    n_layers = CFG.num_hidden_layers
    runs_plain, mm_plain = _counts(inputs, with_policy, False, "nothing")
    runs, mm = _counts(inputs, with_policy, True, remat_policy)
    assert runs_plain == n_layers
    saves_flash = remat_policy in ("flash", "flash_dots", "alternate")
    assert runs == (n_layers if saves_flash else 2 * n_layers), (remat_policy, runs)
    # the forward's weight products are recomputed in the backward unless
    # the policy saves them (alternate: its first layer under flash_dots,
    # its second not checkpointed at all); the recompute stops early after
    # the last saved tensor it needs, the input of ``down``, so ``down``
    # itself is never run again
    saves_dots = remat_policy in ("dots", "flash_dots", "alternate")
    want = 0 if saves_dots else (len(WEIGHTS) - 1) * n_layers
    assert mm - mm_plain == want, (remat_policy, mm)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        tllama.run_layers_nocache({"layers": {}}, TCFG, torch.zeros(1, 2, 64),
                                  torch.zeros(1, 2, dtype=torch.int32), remat=True,
                                  remat_policy="bogus")


@pytest.mark.parametrize("lo,hi", [(0, 1), (1, 4)])
def test_alternate_needs_an_even_layer_count(lo, hi):
    with pytest.raises(ValueError, match="pairs"):
        tllama.run_layers_nocache({"layers": {}}, TCFG, torch.zeros(1, 2, 64),
                                  torch.zeros(1, 2, dtype=torch.int32), lo=lo, hi=hi,
                                  remat=True, remat_policy="alternate")
