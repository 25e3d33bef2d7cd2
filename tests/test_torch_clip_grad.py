"""The CLIP tower is differentiable in the port as in the JAX package: the
port's tower goes through ``flash_attention_vjp`` (K1 forward, K3 backward on
the card; the plain version on the CPU), and the gradient of
``encode_images(frozen_tower=False)`` with respect to the tower's
``patch_embedding`` equals ``jax.grad`` of the JAX function on bridged fp32
weights (atol 1e-5 + rtol 1e-4: fp32 sums in another order through 2 tower
layers and the projector)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import LlavaConfig
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu_torch.models import clip as tclip
from dynamic_llava_tpu_torch.models import dynamic as tdyn
from dynamic_llava_tpu_torch.ops import flash_attention as tfa
from dynamic_llava_tpu_torch.weights import params_from_numpy

from test_torch_config import port_config

CFG = LlavaConfig.tiny()


@pytest.fixture(scope="module")
def setup():
    jp = jax.jit(jdyn.init_llava_params, static_argnums=(1,))(jax.random.key(0), CFG)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    rng = np.random.default_rng(0)
    size = CFG.vision.image_size
    pix = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    n_img, d = CFG.num_image_tokens, CFG.text.hidden_size
    return jp, tp, pix, rng.normal(size=(2, n_img, d)).astype(np.float32)


def _torch_grad(tp, pix, g, frozen_tower):
    leaf = tp["vision_tower"]["patch_embedding"].clone().requires_grad_(True)
    params = dict(tp, vision_tower=dict(tp["vision_tower"], patch_embedding=leaf))
    out = tdyn.encode_images(params, port_config(CFG), torch.from_numpy(pix),
                             frozen_tower=frozen_tower)
    loss = (out * torch.from_numpy(g)).sum()
    if frozen_tower:
        assert not loss.requires_grad  # no leaf of the tower is in the graph
        return None
    return torch.autograd.grad(loss, leaf)[0]


def test_tower_gradient_matches_jax(setup):
    jp, tp, pix, g = setup

    def loss(patch_embedding):
        params = dict(jp, vision_tower=dict(jp["vision_tower"],
                                            patch_embedding=patch_embedding))
        return (jdyn.encode_images(params, CFG, jnp.asarray(pix)) * jnp.asarray(g)).sum()

    want = np.asarray(jax.grad(loss)(jp["vision_tower"]["patch_embedding"]))
    got = _torch_grad(tp, pix, g, frozen_tower=False).numpy()
    assert np.abs(want).max() > 1e-3 and np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_frozen_tower_has_no_gradient(setup):
    _, tp, pix, g = setup
    assert _torch_grad(tp, pix, g, frozen_tower=True) is None


def test_tower_attention_goes_through_the_differentiable_wrapper(setup, monkeypatch):
    """Every tower layer calls ``flash_attention_vjp`` (non-causal), which on
    the card runs K1 inside an autograd Function; under ``no_grad`` the
    Function is not built (serving and a frozen tower pay nothing)."""
    _, tp, pix, _ = setup
    calls, built = [], []
    real = tfa.flash_attention_vjp
    real_apply = tfa._FlashAttentionFn.apply

    def spy(q, k, v, **kw):
        calls.append(kw)
        return real(q, k, v, **kw)

    monkeypatch.setattr(tclip, "flash_attention_vjp", spy)
    monkeypatch.setattr(tfa._FlashAttentionFn, "apply",
                        lambda *a: built.append(1) or real_apply(*a))
    vcfg = port_config(CFG).vision
    n_run = vcfg.num_hidden_layers + vcfg.select_layer + 1
    with torch.no_grad():
        tclip.vision_tower_features(tp["vision_tower"], vcfg, torch.from_numpy(pix))
    assert len(calls) == n_run and all(kw == {"causal": False} for kw in calls)
    assert not built
    leaf = tp["vision_tower"]["patch_embedding"].clone().requires_grad_(True)
    tclip.vision_tower_features(dict(tp["vision_tower"], patch_embedding=leaf), vcfg,
                                torch.from_numpy(pix))
    assert len(built) == n_run
