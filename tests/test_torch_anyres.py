"""Anyres (high-resolution tiling) in the port against the JAX package,
fp32, tiny config, shared (bridged) weights: the host merge (an own copy),
``encode_images_anyres`` on the port's tower, ``prefill(image_features=)``
(state and logits), ``Generator.generate_anyres`` token for token, dense and
sparse, on wide, tall, square and odd aspect ratios and with a
``model_max_length`` that cuts an image, and ``remap_span_starts``."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from PIL import Image

from dynamic_llava_tpu import mm_utils as jmm
from dynamic_llava_tpu.config import DENSE_SPARSE_CONFIG, LlavaConfig, SparseConfig
from dynamic_llava_tpu.constants import IMAGE_TOKEN_INDEX
from dynamic_llava_tpu.generation.generate import GenerationConfig as JGenCfg
from dynamic_llava_tpu.generation.generate import Generator as JGen
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu.multimodal import anyres as janyres
from dynamic_llava_tpu.multimodal.fusion import plan_batch
from dynamic_llava_tpu.ops import sparsify as jsparsify
from dynamic_llava_tpu_torch import mm_utils as tmm
from dynamic_llava_tpu_torch.generation.generate import GenerationConfig as TGenCfg
from dynamic_llava_tpu_torch.generation.generate import Generator as TGen
from dynamic_llava_tpu_torch.models import dynamic as tdyn
from dynamic_llava_tpu_torch.multimodal import anyres as tanyres
from dynamic_llava_tpu_torch.ops import sparsify as tsparsify
from dynamic_llava_tpu_torch.weights import params_from_numpy

from test_torch_config import port_config

# the sparse config with the instruct predictor on too: with pre-encoded
# features the vision predictor is skipped, the two text predictors apply
SPARSE = LlavaConfig.tiny(sparse=SparseConfig(d_model=32, nhead=2, dim_feedforward=64,
                                              num_layers=1, use_instruct_predictor=True))
DENSE = LlavaConfig.tiny(sparse=DENSE_SPARSE_CONFIG)
PINPOINTS = [[56, 112], [112, 56], [112, 112]]  # the tiny tower is 56 px
SIZES = {"wide": (112, 56), "tall": (56, 112), "square": (100, 100), "odd": (90, 60)}
GEN = dict(max_new_tokens=10, decode_chunk=4, pad_multiple=8, eos_token_id=-1)


@pytest.fixture(scope="module")
def weights():
    jp = jax.jit(jdyn.init_llava_params, static_argnums=(1,))(jax.random.key(0), SPARSE)
    jp = dict(jp, image_newline=jax.random.normal(jax.random.key(1), (SPARSE.text.hidden_size,)))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


def _image(size, seed):
    w, h = size
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8))


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [np.concatenate([rng.integers(3, 500, 3 + i), [IMAGE_TOKEN_INDEX],
                            rng.integers(3, 500, 5)]) for i in range(n)]


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("merge_type", ["spatial_unpad", "spatial", "flat"])
def test_host_merge_matches_jax(size, merge_type):
    """``unpad_feature_grid`` and ``merge_anyres_features`` (the own copy)
    give JAX's arrays for each aspect ratio and merge type."""
    w, h = SIZES[size]
    gw, gh = jmm.get_anyres_image_grid_shape((w, h), PINPOINTS, 56)
    feats = np.random.default_rng(w * h).normal(size=(gw * gh + 1, 16, 6)).astype(np.float32)
    nl = np.arange(6, dtype=np.float32)
    args = (feats, (w, h), PINPOINTS, 56, 4, nl, merge_type)
    want = janyres.merge_anyres_features(*args)
    np.testing.assert_array_equal(tanyres.merge_anyres_features(*args), want)
    grid = feats[1:].reshape(gh * 4, gw * 4, 6) if gw * gh else feats
    np.testing.assert_array_equal(tanyres.unpad_feature_grid(grid, (w, h)),
                                  janyres.unpad_feature_grid(grid, (w, h)))


def test_encode_images_anyres_matches_jax(weights):
    """Each image's tiles through the port's tower and projector, merged
    with the params' ``image_newline``, within fp32 tolerance of JAX."""
    jp, tp = weights
    sizes = [SIZES["odd"], SIZES["tall"]]
    images = [_image(s, i) for i, s in enumerate(sizes)]
    proc = jmm.ClipImagePreprocessor(size=56, crop_size=56)
    tiles = [jmm.process_anyres_image(im, proc, PINPOINTS) for im in images]
    want = janyres.encode_images_anyres(jp, SPARSE, [jnp.asarray(t) for t in tiles], sizes,
                                        PINPOINTS)
    got = tanyres.encode_images_anyres(tp, port_config(SPARSE), tiles, sizes, PINPOINTS)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-4)
    # without the leaf the newline is zeros, as in JAX
    no_nl = {k: v for k, v in tp.items() if k != "image_newline"}
    merged = tanyres.encode_images_anyres(no_nl, port_config(SPARSE), tiles[:1], sizes[:1],
                                          PINPOINTS)[0]
    assert np.count_nonzero(np.all(merged == 0.0, axis=1)) > 0


@pytest.mark.parametrize("cfg", [SPARSE, DENSE], ids=["sparse", "dense"])
def test_prefill_with_image_features_matches_jax(weights, cfg):
    """``prefill(image_features=)`` (a keyword in the port, positional in
    JAX): the same logits, lengths, kept positions and cache rows; the
    vision predictor is skipped (no image keep mask)."""
    jp, tp = weights
    counts = [52, 37]
    plan = plan_batch(_prompts(2), 0, tokens_per_image_list=[[n] for n in counts])
    feats = np.random.default_rng(3).normal(
        size=(2, max(counts), cfg.text.hidden_size)).astype(np.float32)
    pre, post = jdyn.gen_cache_sizes(cfg, plan.seq_len, 8, all_have_image=False)
    i32 = dict(dtype=np.int32)
    args = [plan.token_ids, plan.is_image, plan.image_slot, plan.valid_len,
            plan.spans.image_start, plan.spans.last_instruct_start, plan.spans.last_instruct_end,
            plan.spans.has_image]
    jcache = jdyn.make_gen_cache(cfg, 2, plan.seq_len, 8, jnp.float32, all_have_image=False)
    jstate, jinfo = jdyn.prefill(jp, cfg, *map(jnp.asarray, args), None, jcache,
                                 jnp.asarray(feats))
    tcfg = port_config(cfg)
    tcache = tdyn.make_gen_cache(tcfg, 2, plan.seq_len, 8, torch.float32, all_have_image=False,
                                 device="cpu")
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    tstate, tinfo = tdyn.prefill(tp, tcfg, *targs, None, tcache,
                                 image_features=torch.from_numpy(feats))
    assert tinfo.image_keep_mask is None and jinfo.image_keep_mask is None
    np.testing.assert_allclose(tstate.last_logits.numpy(), np.asarray(jstate.last_logits),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_array_equal(tstate.next_pos.numpy(), np.asarray(jstate.next_pos))
    np.testing.assert_array_equal(tinfo.new_length.numpy(), np.asarray(jinfo.new_length))
    n = int(np.asarray(jinfo.new_length).max())
    np.testing.assert_array_equal(tinfo.kept_positions.numpy()[:, :n],
                                  np.asarray(jinfo.kept_positions)[:, :n])
    for tier in ("pre", "post"):
        t, j = getattr(tstate.cache, tier), getattr(jstate.cache, tier)
        np.testing.assert_array_equal(t.length.numpy(), np.asarray(j.length))
        for b in range(2):
            rows = int(np.asarray(j.length)[0, b]) if j.length.size else 0
            np.testing.assert_allclose(t.k.numpy()[:, b, :rows], np.asarray(j.k)[:, b, :rows],
                                       atol=1e-5, rtol=1e-4)
    assert (pre, post) == tuple(x.max_len for x in tstate.cache)
    with pytest.raises(TypeError):  # keyword-only in the port
        tdyn.prefill(tp, tcfg, *targs, None, tcache, torch.from_numpy(feats))


@pytest.mark.parametrize("cfg,sizes,max_len", [
    (DENSE, ("wide", "tall"), 2048),
    (SPARSE, ("square", "odd"), 2048),
    (DENSE, ("square", "odd"), 2048),
    # the planner cuts the 88-token square image (and its text) at 60 tokens
    (SPARSE, ("square", "wide"), 60),
], ids=["dense-wide-tall", "sparse-square-odd", "dense-square-odd", "sparse-cut-at-60"])
def test_generate_anyres_is_token_exact(weights, cfg, sizes, max_len):
    jp, tp = weights
    cfg = dataclasses.replace(cfg, model_max_length=max_len)
    images = [_image(SIZES[s], i + 7) for i, s in enumerate(sizes)]
    ids = _prompts(2, seed=len(sizes[0]))
    want = JGen(jp, cfg, JGenCfg(**GEN)).generate_anyres(
        ids, images, PINPOINTS, jmm.ClipImagePreprocessor(size=56, crop_size=56))
    gen = TGen(tp, port_config(cfg), TGenCfg(**GEN))
    proc = tmm.ClipImagePreprocessor(size=56, crop_size=56)
    got = gen.generate_anyres(ids, images, PINPOINTS, proc)
    assert got == want and all(len(t) == GEN["max_new_tokens"] for t in got)
    plan, _, counts = gen.anyres_inputs(ids, images, PINPOINTS, proc)
    fused = [len(p) - 1 + n for p, n in zip(ids, counts)]
    assert list(plan.valid_len) == [min(f, max_len) for f in fused]
    if max_len < max(fused):
        assert plan.seq_len == max_len


@pytest.mark.parametrize("seed", range(3))
def test_remap_span_starts_matches_jax(seed):
    rng = np.random.default_rng(seed)
    keep = rng.random((4, 23)) < 0.6
    span = rng.integers(0, 24, size=4).astype(np.int32)
    want = np.asarray(jsparsify.remap_span_starts(jnp.asarray(span), jnp.asarray(keep)))
    got = tsparsify.remap_span_starts(torch.from_numpy(span), torch.from_numpy(keep))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
