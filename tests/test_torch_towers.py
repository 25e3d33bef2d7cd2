"""The S2 multi-scale and TokenPacker towers, on-device preprocessing and
the projector types of the port against the JAX package, fp32, on the
``tests/test_towers.py`` tower config and shared (bridged) weights.

Tolerances: S2 and TokenPacker atol 1e-5 / rtol 1e-4 (the bilinear resizes
are the same antialiased triangle filter in both); preprocessing atol 1e-5
on the normalized scale against the JAX graph (the measured difference is
~2e-6: both resize with the Keys cubic, a = -0.5, antialiased), and
``tests/test_preprocess.py``'s bounds against the PIL pipeline."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from PIL import Image

from dynamic_llava_tpu.config import ClipVisionConfig
from dynamic_llava_tpu.models import projector as jproj
from dynamic_llava_tpu.models import towers as jtowers
from dynamic_llava_tpu.models.clip import init_clip_params
from dynamic_llava_tpu.ops import preprocess as jpre
from dynamic_llava_tpu_torch import mm_utils as tmm
from dynamic_llava_tpu_torch.models import clip as tclip
from dynamic_llava_tpu_torch.models import projector as tproj
from dynamic_llava_tpu_torch.models import towers as ttowers
from dynamic_llava_tpu_torch.ops import preprocess as tpre
from dynamic_llava_tpu_torch.weights import _projector_depth, params_from_numpy

from test_torch_config import port_config

ATOL, RTOL = 1e-5, 1e-4
CFG = ClipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=4,
                       num_attention_heads=2, image_size=56, patch_size=14)


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu", torch.float32)


@pytest.fixture(scope="module")
def tower():
    jp = init_clip_params(jax.random.key(0), CFG)
    return jp, _bridge(jp)


def _images(b, seed, size=56):
    return np.random.default_rng(seed).normal(size=(b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("scales", [(56, 112), (56, 112, 168)])
def test_s2_features_match_jax(tower, scales):
    """Each scale tiled, encoded, merged and pooled back; the first channel
    block is the single-scale tower's (JAX ``tests/test_towers.py``)."""
    jp, tp = tower
    imgs = _images(2, 0)
    want = np.asarray(jtowers.s2_tower_features(jp, CFG, jnp.asarray(imgs), scales=scales))
    got = ttowers.s2_tower_features(tp, port_config(CFG), torch.from_numpy(imgs),
                                    scales=scales).numpy()
    assert got.shape == (2, CFG.num_patches, CFG.hidden_size * len(scales))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    base = tclip.vision_tower_features(tp, port_config(CFG), torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got[..., :CFG.hidden_size], base, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("multi_layers", [(1, 2, 3), (2, 4)])
def test_tokenpacker_tower_and_projector_match_jax(tower, multi_layers):
    """The tower's taps and the point-to-region projector at raw grid 4,
    scale factor 2, on the JAX ``init_tokenpacker_params`` weights."""
    jp, tp = tower
    imgs = _images(2, 1)
    js, jm = jtowers.tokenpacker_tower_features(jp, CFG, jnp.asarray(imgs),
                                                multi_layers=multi_layers)
    ts, tm = ttowers.tokenpacker_tower_features(tp, port_config(CFG), torch.from_numpy(imgs),
                                                multi_layers=multi_layers)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=RTOL)
    multi_dim = CFG.hidden_size * len(multi_layers)
    jpk = jtowers.init_tokenpacker_params(jax.random.key(2), kv_dim=32, multi_dim=multi_dim,
                                          embed_dim=32, hidden_size=64, num_heads=2)
    tpk = _bridge(jpk)
    want = np.asarray(jtowers.tokenpacker_project(jpk, js, jm, raw_grid=4, scale_factor=2))
    got = ttowers.tokenpacker_project(tpk, ts, tm, raw_grid=4, scale_factor=2).numpy()
    assert got.shape == (2, 4, 64)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_tokenpacker_params_have_the_jax_structure():
    jpk = jtowers.init_tokenpacker_params(jax.random.key(0), 8, 24, 16, 32, 2)
    tpk = ttowers.init_tokenpacker_params(torch.Generator().manual_seed(0), 8, 24, 16, 32, 2,
                                          device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(np.shape(a)), t)  # noqa: E731
    assert shapes(jax.tree.map(np.asarray, jpk)) == shapes(
        jax.tree.map(lambda a: a.numpy() if isinstance(a, torch.Tensor) else a, tpk))


@pytest.mark.parametrize("mode", ["pad", "square"])
@pytest.mark.parametrize("hw", [(48, 72), (72, 48), (56, 56)])
def test_preprocess_matches_jax_and_pil(mode, hw):
    """uint8 frames -> normalized NHWC at 56: ``preprocess_image`` against
    the JAX graph, ``preprocess_batch`` against ``preprocess_image`` frame by
    frame, and pad mode within ``tests/test_preprocess.py``'s bounds of the
    PIL pipeline (mean error < 0.02, 99th percentile < 0.15)."""
    h, w = hw
    frames = np.random.default_rng(h + w).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    want = np.asarray(jpre.preprocess_batch(jnp.asarray(frames), out_size=56, mode=mode))
    got = tpre.preprocess_batch(frames, out_size=56, mode=mode, device="cpu")
    assert got.shape == (2, 56, 56, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    one = tpre.preprocess_image(torch.from_numpy(frames[1]), out_size=56, mode=mode)
    np.testing.assert_array_equal(one.numpy(), got[1].numpy())
    if mode == "pad":
        proc = tmm.ClipImagePreprocessor(size=56, crop_size=56)
        ref = proc(tmm.expand2square(Image.fromarray(frames[0]), proc.background_color))
        err = np.abs(got[0].numpy() - ref)
        assert np.mean(err) < 0.02 and np.quantile(err, 0.99) < 0.15


def test_preprocess_defaults_to_the_card():
    frame = np.zeros((8, 8, 3), np.uint8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tpre.preprocess_image(frame)


@pytest.mark.parametrize("kind", ["linear", "identity", "mlp2x_gelu", "mlp3x_gelu"])
def test_projector_types_match_jax(kind):
    """The projectors the code takes, each held against the JAX
    ``apply_projector`` on the same weights and features."""
    jp = jproj.init_projector_params(jax.random.key(3), kind, 32, 48)
    tp = _bridge(jp)
    assert len(tp) == _projector_depth(kind)
    x = np.random.default_rng(4).normal(size=(2, 16, 32)).astype(np.float32)
    want = np.asarray(jproj.apply_projector(jp, jnp.asarray(x)))
    got = tproj.apply_projector(tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
