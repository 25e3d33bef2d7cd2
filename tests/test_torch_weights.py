"""The weight bridge and the model modules of the port against the JAX
package: JAX ``init_llava_params`` goes through ``params_from_numpy`` and
the decoder, CLIP tower, projector and predictor forwards must match their
JAX counterparts in fp32 (atol 1e-5 / rtol 1e-4 unless stated)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import ClipVisionConfig, LlamaConfig, LlavaConfig, SparseConfig
from dynamic_llava_tpu.models import clip as jclip
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu.models import llama as jllama
from dynamic_llava_tpu.models import predictors as jpred
from dynamic_llava_tpu.models import projector as jproj
from dynamic_llava_tpu.ops.kv_cache import init_cache as jinit_cache
from dynamic_llava_tpu_torch.models import clip as tclip
from dynamic_llava_tpu_torch.models import llama as tllama
from dynamic_llava_tpu_torch.models import predictors as tpred
from dynamic_llava_tpu_torch.models import projector as tproj
from dynamic_llava_tpu_torch.ops.kv_cache import init_cache as tinit_cache
from dynamic_llava_tpu_torch.weights import init_llava_params, params_from_numpy

from test_torch_config import port_config

ATOL, RTOL = 1e-5, 1e-4

# GQA decoder (4 query heads over 2 kv heads) so the K/V head grouping runs
CFG = LlavaConfig(
    text=LlamaConfig.tiny(num_key_value_heads=2),
    vision=ClipVisionConfig.tiny(),
    sparse=SparseConfig(d_model=32, nhead=2, dim_feedforward=64, num_layers=2,
                        use_instruct_predictor=True),
)

TCFG = port_config(CFG)  # the port's own dataclasses, same field values


@pytest.fixture(scope="module")
def both():
    init = jax.jit(jdyn.init_llava_params, static_argnums=(1,))
    jp = jax.tree.map(np.asarray, init(jax.random.key(0), CFG))
    return jp, params_from_numpy(jp, "cpu", torch.float32)


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_bridge_keeps_structure_and_values(both):
    jp, tp = both
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for name in jl:
        assert tl[name].dtype == torch.float32, name
        np.testing.assert_array_equal(tl[name].numpy(), jl[name], err_msg=name)


def test_bridge_dtype_and_device(both):
    jp, _ = both
    tp = params_from_numpy(jp, torch.device("cpu"), torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 and t.device.type == "cpu"
               for _, t in _leaves(tp))


def test_bridge_keeps_quantized_leaves_int8():
    """``q`` / ``q4`` leaves stay int8 bit for bit; scales take the
    requested dtype."""
    rng = np.random.default_rng(1)
    tree = {"w": {"q": rng.integers(-127, 128, (4, 8)).astype(np.int8),
                  "s": rng.random((1, 8)).astype(np.float32)},
            "u": {"q4": rng.integers(-128, 128, (4, 4)).astype(np.int8),
                  "s": np.asarray(jnp.asarray(rng.random((1, 8)), jnp.bfloat16))}}
    tp = params_from_numpy(tree, "cpu", torch.bfloat16)
    for name in ("w", "u"):
        key = "q" if name == "w" else "q4"
        assert tp[name][key].dtype == torch.int8
        np.testing.assert_array_equal(tp[name][key].numpy(), tree[name][key])
        want = torch.from_numpy(np.asarray(tree[name]["s"], np.float32)).bfloat16()
        torch.testing.assert_close(tp[name]["s"], want, atol=0, rtol=0)


def test_torch_init_has_the_jax_structure(both):
    jp, _ = both
    tp = init_llava_params(TCFG, torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    jshapes = {k: tuple(v.shape) for k, v in _leaves(jp)}
    tshapes = {k: tuple(v.shape) for k, v in _leaves(tp)}
    assert jshapes == tshapes
    w = tp["llm"]["layers"]["q"].float()
    assert w.dtype == torch.float32 and abs(w.std().item() - 0.02) < 0.005
    assert (tp["llm"]["layers"]["input_ln"] == 1).all()


def test_embed_and_lm_head_match_jax(both):
    jp, tp = both
    ids = np.random.default_rng(0).integers(0, CFG.text.vocab_size, (2, 7)).astype(np.int32)
    _close(tllama.embed_tokens(tp["llm"], torch.from_numpy(ids)),
           jllama.embed_tokens(jp["llm"], jnp.asarray(ids)), atol=0, rtol=0)
    x = _np((2, 3, CFG.text.hidden_size), 1)
    got = tllama.lm_head(tp["llm"], TCFG.text, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, jllama.lm_head(jp["llm"], CFG.text, jnp.asarray(x)))


def test_decoder_prefill_and_decode_match_jax(both):
    """Prefill layers [1, 4) over a ragged batch, then one decode step:
    hidden states, cache contents and lengths on valid rows. (Padding rows
    differ by design: the port masks them to the valid length so K1 can
    skip padding tiles, the JAX prefill lets them attend the padding; no
    valid row or later step reads them.)"""
    jp, tp = both
    tcfg = CFG.text
    b, s, lo, hi = 2, 12, 1, 4
    x = _np((b, s, tcfg.hidden_size), 2)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    valid = np.array([12, 7], np.int32)
    jc = jinit_cache(tcfg, b, 16, jnp.float32, num_layers=hi - lo)
    tc = tinit_cache(TCFG.text, b, 16, torch.float32, num_layers=hi - lo)
    jr = jax.jit(jllama.run_layers_prefill, static_argnums=(1,), static_argnames=("lo", "hi"))(
        jp["llm"], tcfg, jnp.asarray(x), jnp.asarray(pos), jc, jnp.asarray(valid), lo=lo, hi=hi)
    tr = tllama.run_layers_prefill(tp["llm"], TCFG.text, torch.from_numpy(x),
                                   torch.from_numpy(pos), tc, torch.from_numpy(valid),
                                   lo=lo, hi=hi)
    for i, n in enumerate(valid):
        _close(tr.x[i, :n], jr.x[i, :n])
        _close(tr.cache.k[:, i, :n], jr.cache.k[:, i, :n])
        _close(tr.cache.v[:, i, :n], jr.cache.v[:, i, :n])
    np.testing.assert_array_equal(tr.cache.length.numpy(), np.asarray(jr.cache.length))

    xd = _np((b, 1, tcfg.hidden_size), 3)
    posd = valid[:, None]
    jd = jax.jit(jllama.run_layers_decode, static_argnums=(1,), static_argnames=("lo", "hi"))(
        jp["llm"], tcfg, jnp.asarray(xd), jnp.asarray(posd), jr.cache, lo=lo, hi=hi)
    td = tllama.run_layers_decode(tp["llm"], TCFG.text, torch.from_numpy(xd),
                                  torch.from_numpy(posd), tr.cache, lo=lo, hi=hi)
    _close(td.x, jd.x)
    for i, n in enumerate(valid):  # persisted rows and the new slot
        _close(td.cache.k[:, i, :n + 1], jd.cache.k[:, i, :n + 1])
        _close(td.cache.v[:, i, :n + 1], jd.cache.v[:, i, :n + 1])


def test_clip_tower_matches_jax(both):
    jp, tp = both
    pix = _np((2, CFG.vision.image_size, CFG.vision.image_size, 3), 4)
    got = tclip.vision_tower_features(tp["vision_tower"], TCFG.vision, torch.from_numpy(pix))
    want = jax.jit(jclip.vision_tower_features, static_argnums=(1,))(
        jp["vision_tower"], CFG.vision, jnp.asarray(pix))
    assert got.shape == (2, CFG.vision.num_patches, CFG.vision.hidden_size)
    _close(got, want)


def test_patchify_matches_jax():
    img = _np((2, 28, 42, 3), 5)
    _close(tclip.patchify(torch.from_numpy(img), 14), jclip.patchify(jnp.asarray(img), 14),
           atol=0, rtol=0)


def test_projector_matches_jax(both):
    jp, tp = both
    x = _np((2, 5, CFG.vision.hidden_size), 6) * 3  # wide enough to see erf vs tanh
    _close(tproj.apply_projector(tp["mm_projector"], torch.from_numpy(x)),
           jproj.apply_projector(jp["mm_projector"], jnp.asarray(x)))


def test_vision_predictor_matches_jax(both):
    jp, tp = both
    x = _np((2, CFG.num_image_tokens, CFG.text.hidden_size), 7)
    pol = (np.random.default_rng(8).random((2, CFG.num_image_tokens, 1)) > 0.3)
    pol = pol.astype(np.float32)
    # under one jit a form (the weights closed over): one compile, not one an op
    jfn = jax.jit(lambda x_, pol_: jpred.vision_predictor(
        jp["predictors"]["image_score_predictor"], x_, CFG.sparse, pol_))
    for policy in (None, pol):
        got = tpred.vision_predictor(
            tp["predictors"]["image_score_predictor"], torch.from_numpy(x), TCFG.sparse,
            None if policy is None else torch.from_numpy(policy))
        want = jfn(jnp.asarray(x), None if policy is None else jnp.asarray(policy))
        _close(got, want)


@pytest.mark.parametrize("name", ["output_text_score_predictor", "instruct_score_predictor"])
def test_text_predictors_match_jax(both, name):
    jp, tp = both
    x = _np((3, 4, CFG.text.hidden_size), 9)
    _close(tpred.text_predictor(tp["predictors"][name], torch.from_numpy(x)),
           jpred.text_predictor(jp["predictors"][name], jnp.asarray(x)))
