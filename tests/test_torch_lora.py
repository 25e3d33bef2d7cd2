"""The port's LoRA / QLoRA (``train/lora.py``, the adapter deltas in
``ops.quant.linear`` / ``linear_group``, ``lora_mode`` in the train step
and the ``Trainer``) against the JAX package, on the CPU at a tiny size,
fp32. The cases of ``tests/test_lora.py`` and
``tests/test_train_stages.py::test_qlora_train_step``, plus:

- bridged JAX adapters with a nonzero B give the JAX outputs in
  ``layer_nocache`` (atol 1e-5 / rtol 1e-4), prefill, decode and
  ``prefill_continue`` (the extend path; logits atol 2e-4 / rtol 2e-3, the
  tolerance of ``tests/test_torch_extend.py``);
- greedy ``Generator.generate`` and a two-round ``ChatSession`` with
  unmerged adapters are token-exact against JAX and against the port's
  merged model;
- ``matmul_q4_mlp`` refuses adapted leaves, ``quantize_llm_params`` leaves
  adapters alone, and a QLoRA step (int8 and int4 base) leaves the base
  bytes equal, moves every adapter B and makes no gradient buffer for the
  base.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import LlavaConfig, SparseConfig
from dynamic_llava_tpu.generation.generate import ChatSession as JChat
from dynamic_llava_tpu.generation.generate import GenerationConfig as JGenCfg
from dynamic_llava_tpu.generation.generate import Generator as JGen
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu.models import llama as jllama
from dynamic_llava_tpu.ops import quant as jquant
from dynamic_llava_tpu.train import lora as jlora
from dynamic_llava_tpu.train import optimizer as jopt
from dynamic_llava_tpu_torch.generation.generate import ChatSession as TChat
from dynamic_llava_tpu_torch.generation.generate import GenerationConfig as TGenCfg
from dynamic_llava_tpu_torch.generation.generate import Generator as TGen
from dynamic_llava_tpu_torch.models import llama as tllama
from dynamic_llava_tpu_torch.ops import quant as tquant
from dynamic_llava_tpu_torch.train import lora as tlora
from dynamic_llava_tpu_torch.train import optimizer as topt
from dynamic_llava_tpu_torch.train import step as tstep
from dynamic_llava_tpu_torch.train.trainer import Trainer, TrainerConfig
from dynamic_llava_tpu_torch.weights import init_llava_params, named_leaves, params_from_numpy

from test_torch_config import port_config
from test_torch_extend import Both, same
from test_torch_train_model import make_batch, shared_noise

_jinit = jax.jit(jdyn.init_llava_params, static_argnums=(1,))
TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


def _cfg(sparse=True, **kw):
    sp = SparseConfig(d_model=32, nhead=2, dim_feedforward=64, num_layers=1,
                      use_vision_predictor=sparse, use_text_predictor=False,
                      use_output_text_predictor=sparse, use_instruct_predictor=False,
                      output_text_len_for_training=4)
    return LlavaConfig.tiny(sparse=dataclasses.replace(sp, **kw))


def _jax_adapters(cfg, seed=1, b_scale=0.05):
    """JAX adapters (rank 4, alpha 8) with a random nonzero B."""
    ad = jlora.init_lora_params(jax.random.key(seed), cfg.text, rank=4, alpha=8.0)
    rng = np.random.default_rng(seed)
    return {k: dict(v, b=jnp.asarray(rng.normal(scale=b_scale, size=v["b"].shape),
                                     jnp.float32))
            for k, v in ad.items()}


def _adapted(cfg, seed=0, bits=None):
    """(JAX params, port params) of the same weights with the same nonzero
    adapters attached; ``bits`` quantizes the base first."""
    jp = jax.tree.map(np.asarray, _jinit(jax.random.key(seed), cfg))
    if bits is not None:
        jp = jax.tree.map(np.asarray, jquant.quantize_llm_params(
            jax.tree.map(jnp.asarray, jp), bits=bits))
    jp = jax.tree.map(np.asarray, jlora.attach_lora(jp, _jax_adapters(cfg)))
    return jp, params_from_numpy(jp, "cpu", torch.float32)


def _tokens(rows):
    return [np.asarray(r, np.int64) for r in rows]


# -- the module --------------------------------------------------------------------


def test_init_lora_params_shapes_and_scale():
    cfg = port_config(_cfg()).text
    ad = tlora.init_lora_params(cfg, torch.Generator().manual_seed(0), rank=4, alpha=8.0,
                                device="cpu")
    assert sorted(ad) == sorted(f"{t}_lora" for t in TARGETS)
    nq = cfg.num_attention_heads * cfg.head_dim
    assert ad["q_lora"]["a"].shape == (cfg.num_hidden_layers, cfg.hidden_size, 4)
    assert ad["down_lora"]["b"].shape == (cfg.num_hidden_layers, 4, cfg.hidden_size)
    assert ad["o_lora"]["a"].shape[1] == nq
    for v in ad.values():
        assert v["s"].dim() == 0 and v["s"].dtype == torch.float32 and float(v["s"]) == 2.0
        assert not v["b"].any()
        assert abs(float(v["a"].std()) - 0.5) < 0.05  # N(0, 1/r), r = 4
    again = tlora.init_lora_params(cfg, torch.Generator().manual_seed(0), rank=4, alpha=8.0,
                                   device="cpu")
    assert all(torch.equal(again[k]["a"], ad[k]["a"]) for k in ad)


def test_bridge_keeps_the_scale_0d_in_the_adapter_dtype():
    jp, tp = _adapted(_cfg())
    s = tp["llm"]["layers"]["q_lora"]["s"]
    assert s.dim() == 0 and s.dtype == torch.float32 and float(s) == 2.0
    back = tlora.split_lora_state(tp)[0]["q_lora"]["s"]
    assert back is s
    from dynamic_llava_tpu_torch.weights import params_to_numpy

    assert params_to_numpy(tp)["llm"]["layers"]["q_lora"]["s"].shape == ()


def test_lora_noop_at_init_and_merge():
    cfg = _cfg()
    tcfg = port_config(cfg)
    jp = jax.tree.map(np.asarray, _jinit(jax.random.key(0), cfg))
    base = params_from_numpy(jp, "cpu", torch.float32)
    ad = tlora.init_lora_params(tcfg.text, torch.Generator().manual_seed(1), rank=4,
                                alpha=8.0, device="cpu")
    lora = tlora.attach_lora(base, ad)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.text.vocab_size, (1, 6)))

    def forward(p):
        x = tllama.embed_tokens(p["llm"], ids)
        pos = torch.arange(6, dtype=torch.int32)[None]
        return tllama.lm_head(p["llm"], tcfg.text,
                              tllama.run_layers_nocache(p["llm"], tcfg.text, x, pos))

    torch.testing.assert_close(forward(lora), forward(base), atol=1e-6, rtol=0)
    lora["llm"]["layers"]["q_lora"]["b"] = torch.full_like(ad["q_lora"]["b"], 0.01)
    out = forward(lora)
    merged = tlora.merge_lora_pytree(lora)
    assert not any(k.endswith("_lora") for k in merged["llm"]["layers"])
    assert "q_lora" in lora["llm"]["layers"]  # the input is left as it was
    torch.testing.assert_close(forward(merged), out, atol=1e-4, rtol=1e-4)
    assert not torch.allclose(out, forward(base), atol=1e-4)


def test_merge_equals_jax_merge():
    jp, tp = _adapted(_cfg())
    want = jlora.merge_lora_pytree(jax.tree.map(jnp.asarray, jp))["llm"]["layers"]
    got = tlora.merge_lora_pytree(tp)["llm"]["layers"]
    assert sorted(got) == sorted(want)
    for name in TARGETS:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=1e-6,
                                   rtol=1e-6)


def test_merge_refuses_a_quantized_base():
    _, tp = _adapted(_cfg(), bits=8)
    with pytest.raises(ValueError, match="quantized"):
        tlora.merge_lora_pytree(tp)


def test_lora_mode_labels_match_jax():
    jp, tp = _adapted(_cfg())
    want = dict(named_leaves(jopt.label_params(jp, lora_mode=True)))
    got = dict(named_leaves(topt.label_params(tp, lora_mode=True)))
    assert got == want
    assert got["llm/layers/q"] == "frozen" and got["llm/embed"] == "frozen"
    assert got["llm/layers/q_lora/a"] == "base" and got["llm/layers/q_lora/s"] == "frozen"


def test_split_lora_state_keeps_adapters_apart():
    _, tp = _adapted(_cfg())
    adapters, non_lora = tlora.split_lora_state(tp)
    assert set(adapters) == {f"{t}_lora" for t in TARGETS}
    assert set(non_lora) == {"predictors", "mm_projector"}
    stripped = tlora.strip_lora(tp)
    assert not any(k.endswith("_lora") for k in stripped["llm"]["layers"])
    assert "q_lora" in tp["llm"]["layers"]


# -- the dispatch ------------------------------------------------------------------


def _layer_inputs(cfg, b=2, s=7, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, cfg.text.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    return x, pos


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_layer_nocache_with_adapters_matches_jax(bits):
    cfg = _cfg()
    jp, tp = _adapted(cfg, bits=bits)
    x, pos = _layer_inputs(cfg)
    jl = jax.tree.map(jnp.asarray, jp["llm"]["layers"])
    jlp = jax.tree.map(lambda t: t[1] if t.ndim else t, jl)
    # under one jit: one compile, not one an op
    want = jax.jit(jllama.layer_nocache, static_argnums=(1,))(
        jlp, cfg.text, jnp.asarray(x), jnp.asarray(pos), None)
    got = tllama.layer_nocache(tllama.layer_params(tp["llm"]["layers"], 1),
                               port_config(cfg).text, torch.from_numpy(x),
                               torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    # the adapters change the output
    plain = tllama.layer_nocache(tllama.layer_params(tlora.strip_lora(tp)["llm"]["layers"], 1),
                                 port_config(cfg).text, torch.from_numpy(x),
                                 torch.from_numpy(pos))
    assert not torch.allclose(plain, got, atol=1e-3)


@pytest.mark.parametrize("bits", [8, 4])
def test_grouped_gemv_adds_each_delta(bits):
    """Decode rows on a quantized base take the grouped GEMV (K6 / K8 plain
    on the CPU); each projection gets its own adapter's delta."""
    cfg = _cfg()
    _, tp = _adapted(cfg, bits=bits)
    lp = tllama.layer_params(tp["llm"]["layers"], 0)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 1, cfg.text.hidden_size)).astype(np.float32))
    got = tquant.linear_group(lp, ("q", "k", "v"), x)
    for y, name in zip(got, ("q", "k", "v")):
        want = tquant.matmul(x, lp[name]) + tquant.lora_delta(lp, name, x)
        torch.testing.assert_close(y, want, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(tlora.lora_proj(lp, name, x), want, atol=1e-6, rtol=1e-6)
        assert tquant.lora_delta(lp, name, x).abs().max() > 1e-3


def test_matmul_q4_mlp_refuses_adapted_leaves(monkeypatch):
    cfg = _cfg()
    monkeypatch.setenv("DYNAMIC_LLAVA_Q4_MLP", "1")
    _, tp = _adapted(cfg, bits=4)
    lp = tllama.layer_params(tp["llm"]["layers"], 0)
    x = torch.zeros(2, 1, cfg.text.hidden_size)
    bare = {k: v for k, v in lp.items() if not k.endswith("_lora")}
    assert tquant.matmul_q4_mlp(x, bare) is not None
    for name in ("gate", "up", "down"):
        one = dict(bare, **{f"{name}_lora": lp[f"{name}_lora"]})
        assert tquant.matmul_q4_mlp(x, one) is None, name
    # q / k / v / o adapters leave the MLP eligible
    assert tquant.matmul_q4_mlp(x, dict(bare, q_lora=lp["q_lora"])) is not None


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_llm_params_skips_adapters(bits):
    """Adapters attached before ``quantize_llm_params`` come out untouched
    (same tensors), and attaching them after gives the same tree: the
    QLoRA order (quantize, then attach) and the other one agree."""
    cfg = port_config(_cfg())
    p1 = init_llava_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    p2 = {k: v for k, v in p1.items()}
    p2["llm"] = dict(p1["llm"], layers=dict(p1["llm"]["layers"]))
    ad = tlora.init_lora_params(cfg.text, torch.Generator().manual_seed(1), rank=4,
                                device="cpu")
    before = tquant.quantize_llm_params(tlora.attach_lora(p1, ad), bits=bits)
    after = tlora.attach_lora(tquant.quantize_llm_params(p2, bits=bits), ad)
    for name in ad:
        assert all(before["llm"]["layers"][name][k] is ad[name][k] for k in ad[name])
    a, b = dict(named_leaves(before)), dict(named_leaves(after))
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[p], b[p]) for p in a)
    assert tquant.is_quantized(after["llm"]["layers"]["q"])


# -- the step and the Trainer ------------------------------------------------------


def _step_setup(bits, lora_mode=True):
    cfg = _cfg()
    jp, tp = _adapted(cfg, bits=bits)
    if bits is None:  # the JAX init's B: a no-op adapter, as training starts
        for name in TARGETS:
            tp["llm"]["layers"][f"{name}_lora"]["b"].zero_()
    plan, images = make_batch(cfg, b=2)
    opt = topt.make_optimizer(base_lr=1e-3, predictor_lr=1e-3, lora_mode=lora_mode)
    step = tstep.make_train_step(port_config(cfg), opt, remat=False,
                                 labels=topt.label_params(tp, lora_mode=lora_mode))
    return cfg, tp, plan, images, opt, step


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_lora_mode_step_trains_only_adapters_predictors_projector(bits):
    cfg, tp, plan, images, opt, step = _step_setup(bits)
    before = {p: t.clone() for p, t in named_leaves(tp)}
    state = opt.init(tp)
    batch = tstep.batch_from_plan(plan, images, "cpu")
    noise = shared_noise(cfg, jax.random.key(2), plan.batch, plan.seq_len)
    tp, state, metrics = step(tp, state, batch, noise, 1.0)
    assert np.isfinite(float(metrics["loss"]))
    after = dict(named_leaves(tp))
    moved = {p for p in after if not torch.equal(after[p], before[p])}
    trains = {p for p in after if "_lora/" in p and not p.endswith("/s")}
    trains_b = {p for p in trains if p.endswith("/b")}
    assert trains_b <= moved  # every adapter B changed
    assert all(p in trains or p.startswith(("predictors", "mm_projector")) for p in moved), \
        sorted(moved)
    # the base (int8 / int4 values and their scales, or the float weights)
    # and the adapter scales never changed, and got no moments
    for p in after:
        if p.startswith("llm") and p not in trains:
            assert torch.equal(after[p], before[p]), p
            assert p not in state["mu"], p
    assert sorted(state["mu"]) == sorted(
        p for p in after if p in trains or p.startswith(("predictors", "mm_projector")))


def test_qlora_base_never_gets_a_gradient_buffer():
    """Without labels every floating leaf would train; a quantized weight
    (values and scales) and an adapter scale still get no buffer."""
    cfg = _cfg()
    _, tp = _adapted(cfg, bits=4)
    opt = topt.make_optimizer(base_lr=1e-3, predictor_lr=1e-3, lora_mode=True)
    step = tstep.make_train_step(port_config(cfg), opt, remat=False)
    plan, images = make_batch(cfg, b=2)
    batch = tstep.batch_from_plan(plan, images, "cpu")
    seen = []
    real = tstep.trainable_view

    def spy(params, grads):
        seen.append(sorted(grads))
        return real(params, grads)

    tstep.trainable_view = spy
    try:
        step(tp, opt.init(tp), batch, shared_noise(cfg, jax.random.key(2), plan.batch,
                                                  plan.seq_len), 1.0)
    finally:
        tstep.trainable_view = real
    grads = seen[0]
    assert "llm/layers/q_lora/a" in grads and "llm/layers/q_lora/s" not in grads
    assert not any(p.startswith("llm/layers/") and "_lora" not in p
                   and not p.endswith("_ln") for p in grads), grads


def test_qlora_step_matches_jax_loss():
    """One int8 QLoRA step from the same weights, adapters, batch and noise:
    the port's loss equals the JAX step's."""
    from dynamic_llava_tpu.train import step as jstep

    cfg = _cfg()
    jp, tp = _adapted(cfg, bits=8)
    plan, images = make_batch(cfg, b=2)
    jopt_ = jopt.make_optimizer(base_lr=1e-3, predictor_lr=1e-3, lora_mode=True)
    jfn = jstep.make_train_step(cfg, jopt_, remat=False,
                                labels=jopt.label_params(jp, lora_mode=True))
    jparams = jax.tree.map(jnp.asarray, jp)
    key = jax.random.key(2)
    _, _, jm = jfn(jparams, jopt_.init(jparams), jstep.batch_from_plan(plan, images), key,
                   jnp.float32(1.0))
    opt = topt.make_optimizer(base_lr=1e-3, predictor_lr=1e-3, lora_mode=True)
    step = tstep.make_train_step(port_config(cfg), opt, remat=False,
                                 labels=topt.label_params(tp, lora_mode=True))
    _, _, tm = step(tp, opt.init(tp), tstep.batch_from_plan(plan, images, "cpu"),
                    shared_noise(cfg, key, plan.batch, plan.seq_len), 1.0)
    for k in ("loss", "lm_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)


def test_trainer_checkpoint_keeps_adapters_apart_and_resumes(tmp_path):
    cfg = _cfg()
    _, tp = _adapted(cfg)
    plan, images = make_batch(cfg, b=2)
    tc = TrainerConfig(output_dir=str(tmp_path / "a"), num_train_steps=4, logging_steps=1,
                       save_steps=2, warmup_ratio=0.25, learning_rate=1e-3, lora_mode=True,
                       gradient_checkpointing=False)
    tcfg = port_config(cfg)
    full = Trainer(tcfg, tp, tc, device="cpu")
    full.train([(plan, images)] * 4)
    full.logger.close()
    ckpt = torch.load(tmp_path / "a" / "ckpt" / "step_2.pt", weights_only=True)
    assert sorted(ckpt["lora"]) == sorted(f"{t}_lora" for t in TARGETS)
    assert sorted(ckpt["params"]) == ["mm_projector", "predictors"]  # no frozen base
    _, tp2 = _adapted(cfg)
    resumed = Trainer(tcfg, tp2, dataclasses.replace(tc, output_dir=str(tmp_path / "b")),
                      device="cpu")
    os.makedirs(tmp_path / "b" / "ckpt")
    os.replace(tmp_path / "a" / "ckpt" / "step_2.pt", tmp_path / "b" / "ckpt" / "step_2.pt")
    assert resumed.maybe_resume() and resumed.step == 2
    resumed.train([(plan, images)] * 2)
    resumed.logger.close()
    a, b = dict(named_leaves(full.params)), dict(named_leaves(resumed.params))
    assert all(torch.equal(a[p], b[p]) for p in a)


def test_trainer_resumes_a_checkpoint_without_adapters(tmp_path):
    """A checkpoint with no ``"lora"`` entry (the format before adapters were
    kept apart) resumes a trainer without adapters; a trainer with adapters
    refuses it with a clear error."""
    cfg = _cfg()
    tcfg = port_config(cfg)
    plan, images = make_batch(cfg, b=2)
    tc = TrainerConfig(output_dir=str(tmp_path / "a"), num_train_steps=2, logging_steps=1,
                       save_steps=2, warmup_ratio=0.25, learning_rate=1e-3,
                       gradient_checkpointing=False)
    def base():
        return params_from_numpy(jax.tree.map(np.asarray, _jinit(jax.random.key(0), cfg)),
                                 "cpu", torch.float32)

    first = Trainer(tcfg, base(), tc, device="cpu")
    first.train([(plan, images)] * 2)
    first.logger.close()
    path = tmp_path / "a" / "ckpt" / "step_2.pt"
    ckpt = torch.load(path, weights_only=True)
    assert ckpt.pop("lora") == {}
    torch.save(ckpt, path)
    again = Trainer(tcfg, base(), tc, device="cpu")
    assert again.maybe_resume() and again.step == 2
    a, b = dict(named_leaves(first.params)), dict(named_leaves(again.params))
    assert all(torch.equal(a[p], b[p]) for p in a)
    _, adapted = _adapted(cfg)
    with pytest.raises(ValueError, match="adapters"):
        Trainer(tcfg, adapted, tc, device="cpu").maybe_resume()


# -- outputs against JAX -----------------------------------------------------------


def _adapted_both(cfg, seed=0):
    both = Both(cfg, seed)
    jp, tp = _adapted(cfg, seed)
    both.jp, both.tp = jax.tree.map(jnp.asarray, jp), tp
    return both


def test_prefill_decode_extend_with_adapters_match_jax():
    both = _adapted_both(_cfg(sparse=False))
    rng = np.random.default_rng(0)
    vocab = both.jcfg.text.vocab_size
    states = both.prefill(rng.integers(3, vocab, size=(2, 9)))
    same(states)
    states, _ = both.decode(states)
    same(states)
    states = both.cont(states, rng.integers(3, vocab, size=(2, 5)))
    same(states)
    states, _ = both.decode(states)
    same(states)


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    ids = [np.concatenate([[1, 5], [-200], rng.integers(3, cfg.text.vocab_size, size=(n,))])
           for n in (6, 9)]
    size = cfg.vision.image_size
    return _tokens(ids), rng.normal(size=(2, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("sparse", [True, False])
def test_generate_with_unmerged_adapters_is_token_exact(sparse):
    cfg = _cfg(sparse=sparse)
    jp, tp = _adapted(cfg)
    ids, pix = _prompts(cfg)
    gc = dict(max_new_tokens=8, decode_chunk=4, eos_token_id=cfg.text.vocab_size + 7)
    want = JGen(jax.tree.map(jnp.asarray, jp), cfg, JGenCfg(**gc)).generate(ids, pix)
    got = TGen(tp, port_config(cfg), TGenCfg(**gc)).generate(ids, pix)
    merged = TGen(tlora.merge_lora_pytree(tp), port_config(cfg), TGenCfg(**gc)).generate(
        ids, pix)
    plain = TGen(tlora.strip_lora(tp), port_config(cfg), TGenCfg(**gc)).generate(ids, pix)
    assert got == want == merged
    assert plain != got  # the adapters matter


def test_generate_int8_base_with_adapters_matches_jax():
    cfg = _cfg()
    jp, tp = _adapted(cfg, bits=8)
    ids, pix = _prompts(cfg, 1)
    gc = dict(max_new_tokens=8, decode_chunk=4, eos_token_id=cfg.text.vocab_size + 7)
    want = JGen(jax.tree.map(jnp.asarray, jp), cfg, JGenCfg(**gc)).generate(ids, pix)
    assert TGen(tp, port_config(cfg), TGenCfg(**gc)).generate(ids, pix) == want


def test_two_round_chat_with_unmerged_adapters_is_token_exact():
    cfg = _cfg(sparse=False)
    jp, tp = _adapted(cfg)
    rng = np.random.default_rng(2)
    r1 = rng.integers(3, cfg.text.vocab_size, size=(9,))
    r2 = rng.integers(3, cfg.text.vocab_size, size=(5,))
    gc = dict(max_new_tokens=6, decode_chunk=4, eos_token_id=cfg.text.vocab_size + 7)
    js = JChat(JGen(jax.tree.map(jnp.asarray, jp), cfg, JGenCfg(**gc)), max_new_tokens_total=64)
    ts = TChat(TGen(tp, port_config(cfg), TGenCfg(**gc)), 64)
    ms = TChat(TGen(tlora.merge_lora_pytree(tp), port_config(cfg), TGenCfg(**gc)), 64)
    for chunk in (r1, r2):
        want = js.ask(chunk)
        assert ts.ask(chunk) == want == ms.ask(chunk)
        np.testing.assert_allclose(ts.state.last_logits.numpy(),
                                   np.asarray(js.state.last_logits), atol=2e-4, rtol=2e-3)
