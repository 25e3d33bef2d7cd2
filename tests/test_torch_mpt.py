"""The MPT family in the port against the JAX package, fp32, tiny sizes,
on shared (bridged) weights: the ALiBi slopes, ``forward_dense`` (tied and
untied heads, ``clip_qkv``, padding), prefill + decode against JAX and the
no-cache forward, ``forward_multimodal`` (tower -> projector -> splice ->
ALiBi decoder), ``generate_greedy`` token for token, the state-dict round
trip, and the builder's MPT route on an HF checkpoint (where
``transformers`` imports), as ``tests/test_mpt_parity.py`` writes one.
Tolerance: atol 1e-4 / rtol 1e-3 on logits (fp32)."""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import ClipVisionConfig, MptConfig
from dynamic_llava_tpu.constants import IMAGE_TOKEN_INDEX
from dynamic_llava_tpu.models import mpt as jmpt
from dynamic_llava_tpu.models.clip import init_clip_params
from dynamic_llava_tpu.models.projector import init_projector_params
from dynamic_llava_tpu.multimodal.fusion import plan_batch
from dynamic_llava_tpu.ops import kv_cache as jkv
from dynamic_llava_tpu_torch.models import builder as tbuilder
from dynamic_llava_tpu_torch.models import mpt as tmpt
from dynamic_llava_tpu_torch.weights import named_leaves, params_from_numpy

from test_torch_config import port_config

ATOL, RTOL = 1e-4, 1e-3
CFGS = {"tied": MptConfig.tiny(),
        "untied, clip_qkv, 6 heads": MptConfig.tiny(n_heads=6, d_model=48, clip_qkv=0.5,
                                                   tie_word_embeddings=False)}


def _bridge(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


@pytest.fixture(scope="module", params=sorted(CFGS))
def model(request):
    cfg = CFGS[request.param]
    jp = jmpt.init_mpt_params(jax.random.key(1), cfg)
    return cfg, jp, _bridge(jp)


@pytest.mark.parametrize("n_heads", [4, 6, 12, 32])
@pytest.mark.parametrize("bias_max", [8, 16])
def test_alibi_slopes_and_bias_match_jax(n_heads, bias_max):
    np.testing.assert_array_equal(tmpt.alibi_slopes(n_heads, bias_max),
                                  jmpt.alibi_slopes(n_heads, bias_max))
    cfg = MptConfig.tiny(n_heads=n_heads, d_model=8 * n_heads, alibi_bias_max=bias_max)
    q = np.array([[3, 4, 5], [0, 1, 9]], np.int32)
    k = np.arange(10, dtype=np.int32)
    np.testing.assert_array_equal(
        tmpt.alibi_bias(port_config(cfg), torch.from_numpy(q), torch.from_numpy(k)).numpy(),
        np.asarray(jmpt.alibi_bias(cfg, jnp.asarray(q), jnp.asarray(k))))


def test_forward_dense_matches_jax(model):
    cfg, jp, tp = model
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 17)).astype(np.int32)
    valid = np.array([17, 11], np.int32)
    # under one jit a form (the weights closed over): one compile, not one an op
    jfwd = jax.jit(lambda i, v: jmpt.forward_dense(jp, cfg, i, valid_len=v))
    for vl in (None, valid):
        want = np.asarray(jfwd(jnp.asarray(ids), None if vl is None else jnp.asarray(vl)))
        got = tmpt.forward_dense(tp, port_config(cfg), torch.from_numpy(ids),
                                 valid_len=None if vl is None else torch.from_numpy(vl))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_prefill_decode_matches_jax_and_nocache(model):
    """Prefill 7 tokens into a static cache, then 6 greedy decode steps: each
    step's logits equal JAX's and the port's no-cache forward over the
    growing sequence; the caches equal JAX's."""
    cfg, jp, tp = model
    tcfg = port_config(cfg)
    b, s, n_decode = 2, 7, 6
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    jc = jkv.init_cache(cfg, b, s + n_decode + 1, dtype=jnp.float32)
    tc = tmpt.init_cache(tcfg, b, s + n_decode + 1, torch.float32, device="cpu")
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    valid = np.full((b,), s, np.int32)
    jr = jax.jit(lambda i, p_, c, v: jmpt.run_layers_prefill(
        jp, cfg, jmpt.embed_tokens(jp, i), p_, c, v))(
        jnp.asarray(ids), jnp.asarray(pos), jc, jnp.asarray(valid))
    tr = tmpt.run_layers_prefill(tp, tcfg, tmpt.embed_tokens(tp, torch.from_numpy(ids)),
                                 torch.from_numpy(np.ascontiguousarray(pos)), tc,
                                 torch.from_numpy(valid))
    jc, tc = jr.cache, tr.cache
    jl = np.asarray(jmpt.lm_head(jp, cfg, jr.x))[:, s - 1]
    tl = tmpt.lm_head(tp, tcfg, tr.x)[:, s - 1]
    seq = torch.from_numpy(ids)
    jdecode = jax.jit(lambda p, x, pos, c: jmpt.run_layers_decode(p, cfg, x, pos, c))
    for step in range(n_decode):
        np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tl.numpy(), tmpt.forward_dense(tp, tcfg, seq)[:, -1].numpy(),
                                   atol=ATOL, rtol=RTOL)
        nxt = torch.argmax(tl, dim=-1).to(torch.int32)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
        p = np.full((b, 1), s + step, np.int32)
        jd = jdecode(jp, jmpt.embed_tokens(jp, jnp.asarray(nxt.numpy())[:, None]),
                     jnp.asarray(p), jc)
        td = tmpt.run_layers_decode(tp, tcfg, tmpt.embed_tokens(tp, nxt[:, None]),
                                    torch.from_numpy(p), tc)
        jc = jd.cache._replace(length=jd.cache.length + 1)
        tc = td.cache._replace(length=td.cache.length + 1)
        jl = np.asarray(jmpt.lm_head(jp, cfg, jd.x))[:, 0]
        tl = tmpt.lm_head(tp, tcfg, td.x)[:, 0]
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("eos", [None, "first"])
def test_generate_greedy_is_token_exact(model, eos):
    """Eight greedy tokens from 9-token prompts; with an EOS (the first
    token one sample emits) the post-EOS positions repeat it in both."""
    cfg, jp, tp = model
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    plain = np.asarray(jmpt.generate_greedy(jp, cfg, jnp.asarray(ids), 8))
    eos_id = None if eos is None else int(plain[0, 0])
    want = plain if eos is None else np.asarray(
        jmpt.generate_greedy(jp, cfg, jnp.asarray(ids), 8, eos_token_id=eos_id))
    got = tmpt.generate_greedy(tp, port_config(cfg), torch.from_numpy(ids), 8,
                               eos_token_id=eos_id)
    np.testing.assert_array_equal(got.numpy(), want)
    if eos is not None:
        assert (got[0] == eos_id).all()


def test_forward_multimodal_matches_jax():
    """The LLaVA-MPT composition: an image prompt and a text-only call (which
    reduces to ``forward_dense``), each against JAX; the splice is live."""
    cfg, vis = MptConfig.tiny(), ClipVisionConfig.tiny()
    jp = {"llm": jmpt.init_mpt_params(jax.random.key(0), cfg),
          "vision_tower": init_clip_params(jax.random.key(1), vis),
          "mm_projector": init_projector_params(jax.random.key(2), "mlp2x_gelu",
                                                vis.hidden_size, cfg.d_model)}
    tp = _bridge(jp)
    tcfg, tvis = port_config(cfg), port_config(vis)
    rng = np.random.default_rng(5)
    prompts = [np.concatenate([rng.integers(3, cfg.vocab_size, size=4), [IMAGE_TOKEN_INDEX],
                               rng.integers(3, cfg.vocab_size, size=n)]) for n in (5, 9)]
    plan = plan_batch(prompts, vis.num_patches)
    pix = rng.normal(size=(2, vis.image_size, vis.image_size, 3)).astype(np.float32)
    args = (plan.token_ids, plan.is_image, plan.image_slot)
    jfwd = jax.jit(lambda p, i, m, sl, px, vl: jmpt.forward_multimodal(p, cfg, vis, i, m, sl, px,
                                                                       valid_len=vl))
    want = np.asarray(jfwd(jp, *map(jnp.asarray, args), jnp.asarray(pix),
                           jnp.asarray(plan.valid_len)))
    got = tmpt.forward_multimodal(tp, tcfg, tvis, *map(torch.from_numpy, args),
                                  torch.from_numpy(pix),
                                  valid_len=torch.from_numpy(plan.valid_len)).numpy()
    for i in range(2):  # valid rows; padding rows attend nothing in both
        n = int(plan.valid_len[i])
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=ATOL, rtol=RTOL)
    zero = tmpt.forward_multimodal(tp, tcfg, tvis, *map(torch.from_numpy, args),
                                   torch.zeros_like(torch.from_numpy(pix)),
                                   valid_len=torch.from_numpy(plan.valid_len)).numpy()
    last = int(plan.valid_len[0]) - 1
    assert not np.allclose(got[0, last], zero[0, last], atol=1e-4)

    ids = rng.integers(3, cfg.vocab_size, size=(1, 9)).astype(np.int32)
    none = tmpt.forward_multimodal(tp, tcfg, tvis, torch.from_numpy(ids),
                                   torch.zeros((1, 9), dtype=torch.bool),
                                   torch.zeros((1, 9), dtype=torch.int32), None).numpy()
    np.testing.assert_allclose(none, tmpt.forward_dense(tp["llm"], tcfg,
                                                        torch.from_numpy(ids)).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(none, np.asarray(jmpt.forward_dense(jp["llm"], cfg,
                                                                   jnp.asarray(ids))),
                               atol=ATOL, rtol=RTOL)


def test_state_dict_round_trip_and_converter_match_jax(model):
    """``mpt_state_dict`` then ``mpt_params_from_state_dict`` gives back the
    params; the JAX converter reads the same dict to the same leaves."""
    cfg, jp, tp = model
    sd = tmpt.mpt_state_dict(tp)
    back = dict(named_leaves(tmpt.mpt_params_from_state_dict(sd, port_config(cfg), "cpu")))
    orig = dict(named_leaves(tp))
    assert back.keys() == orig.keys() and all(torch.equal(back[k], orig[k]) for k in orig)
    jback = dict(named_leaves(_bridge(jmpt.mpt_params_from_state_dict(sd, cfg))))
    assert jback.keys() == orig.keys() and all(torch.equal(jback[k], orig[k]) for k in orig)


def test_builder_routes_mpt_checkpoints(tmp_path):
    """An HF MPT checkpoint directory (``model_type`` ``mpt``, written as
    ``tests/test_mpt_parity.py`` writes one) loads as an ``MptRuntime`` whose
    logits equal the JAX loader's and HF's; a LLaVA-MPT checkpoint's tower
    and projector under ``transformer.`` load too, equal to JAX's."""
    transformers = pytest.importorskip("transformers")
    from dynamic_llava_tpu.models import builder as jbuilder
    from dynamic_llava_tpu_torch.models.export import clip_state_dict, projector_state_dict

    hf_cfg = transformers.MptConfig(vocab_size=512, d_model=64, n_heads=4, n_layers=2,
                                    max_seq_len=384, layer_norm_epsilon=1e-5,
                                    attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.MptForCausalLM(hf_cfg).eval()
    vis = ClipVisionConfig.tiny()
    tower = _bridge({"vt": init_clip_params(jax.random.key(1), vis),
                     "proj": init_projector_params(jax.random.key(2), "mlp2x_gelu",
                                                   vis.hidden_size, 64)})
    d = tmp_path / "llava-mpt-tiny"
    d.mkdir()
    sd = dict(hf.state_dict())
    sd.update(clip_state_dict(tower["vt"], port_config(vis),
                              prefix=tbuilder.MPT_TOWER_PREFIX))
    sd.update(projector_state_dict(tower["proj"], prefix="transformer.mm_projector."))
    (d / "config.json").write_text(json.dumps({**hf.config.to_dict(),
                                               "mm_projector_type": "mlp2x_gelu"}))
    torch.save(sd, str(d / "pytorch_model.bin"))

    _, rt, proc, ctx = tbuilder.load_pretrained_model(str(d), dtype=torch.float32, device="cpu")
    _, jrt, _, jctx = jbuilder.load_pretrained_model(str(d), dtype=jnp.float32)
    assert isinstance(rt, tbuilder.MptRuntime) and ctx == jctx == 384
    assert rt.cfg == port_config(jrt.cfg) and rt.vision == port_config(jrt.vision)
    assert proc.size == vis.image_size
    got, want = dict(named_leaves(rt.params)), dict(named_leaves(_bridge(jrt.params)))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, err_msg=k)
    ids = np.random.default_rng(7).integers(0, 512, size=(1, 13))
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.numpy()
    ours = tmpt.forward_dense(rt.params["llm"], rt.cfg, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=2e-3)


def test_mpt_7b_config_matches():
    """The card phase's MPT-7B: the JAX defaults, first 8 of 32 layers."""
    cfg = dataclasses.replace(MptConfig(), n_layers=8)
    assert port_config(cfg).head_dim == 128 and port_config(cfg).vocab_size == 50368
