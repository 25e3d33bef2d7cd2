"""The port's mesh (``dynamic_llava_tpu_torch/parallel/sharding.py``) on 8
gloo ranks over a ``(data, fsdp, tensor, pipe) = (2, 2, 2, 1)`` mesh, held
to the JAX package's SINGLE-device functions, the cases of
``tests/test_sharding.py`` and ``tests/test_sharded_inference.py``:

* the sharded ``prefill`` and 3 ``decode_step``s: logits at atol 5e-4 /
  rtol 5e-3 and equal post-tier lengths, on every rank's rows;
* 3 ``decode_speculative_step`` rounds: acceptance counts IDENTICAL;
* a sharded fp32 train step against the JAX ``make_train_step`` on the same
  weights and Gumbel noise: loss at rtol 2e-4 / atol 2e-5, the updated
  ``q`` at rtol 2e-3 / atol 2e-5, the frozen tower unchanged bit for bit,
  ``grad_norm`` against optax's ``global_norm`` (the JAX step's metric);
* grad accumulation 2 against the JAX step with ``grad_accum_steps=2``;
* a ``lora_mode`` step with rank-4 adapters on every target (B non-zero):
  the updated adapters of column-parallel (q, up) and row-parallel (o,
  down) projections against the JAX step's, at the train step's
  tolerances.

ONE spawn of 8 ranks (``torch_mesh_workers.run_ranks``) runs every case; the
JAX references run here. Each rank holds its rows (``data``), its heads
(``tensor``: 4 of 8 query / KV heads in generation) and its ZeRO-3 shards
(``fsdp``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dynamic_llava_tpu.config import ClipVisionConfig, LlamaConfig, LlavaConfig, SparseConfig
from dynamic_llava_tpu.models import dynamic
from dynamic_llava_tpu.multimodal.fusion import plan_batch
from dynamic_llava_tpu.ops.kv_cache import init_tiered_cache
from dynamic_llava_tpu.train.lora import attach_lora, init_lora_params
from dynamic_llava_tpu.train.optimizer import label_params, make_optimizer
from dynamic_llava_tpu.train.step import batch_from_plan, make_train_step

from test_torch_config import port_config
from test_torch_train_model import shared_noise
from torch_mesh_workers import run_ranks

MESH = (2, 2, 2, 1)
WORLD = 8
OPT = dict(base_lr=1e-3, predictor_lr=1e-3)
LORA_CHECKED = ("q", "up", "o", "down")  # column- and row-parallel adapters

# the JAX functions under one jit each: one compile a shape, not one an op
_jinit = jax.jit(dynamic.init_llava_params, static_argnums=(1,))
_jprefill = jax.jit(dynamic.prefill, static_argnums=(1,))
_jdecode = jax.jit(dynamic.decode_step, static_argnums=(1,))
_jspec = jax.jit(dynamic.decode_speculative_step, static_argnums=(1,),
                 static_argnames=("eos_token_id",))


def _gen_cfg():  # tests/test_sharded_inference.py
    return LlavaConfig(
        text=LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=8),
        vision=ClipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=2, image_size=56, patch_size=14),
        sparse=SparseConfig(use_vision_predictor=True, vision_keep_rate=0.25,
                            use_output_text_predictor=True, use_instruct_predictor=False,
                            d_model=32, nhead=2, dim_feedforward=64, num_layers=1),
    )


def _train_cfg():  # tests/test_sharding.py
    return LlavaConfig(
        text=LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=4),
        vision=ClipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=2, image_size=56, patch_size=14),
        sparse=SparseConfig(use_vision_predictor=True, use_output_text_predictor=True,
                            use_instruct_predictor=False, output_text_len_for_training=2,
                            d_model=32, nhead=2, dim_feedforward=64, num_layers=1),
    )


def train_batch(cfg, batch_size, seed=0):
    """The batch of ``tests/test_sharding.py``: ``(plan, images)``."""
    rng = np.random.default_rng(seed)
    ids, labels = [], []
    for _ in range(batch_size):
        row = rng.integers(3, cfg.text.vocab_size, size=(20,)).astype(np.int64)
        row[1] = -200
        lab = row.copy()
        lab[:14] = -100
        ids.append(row)
        labels.append(lab)
    plan = plan_batch(ids, cfg.num_image_tokens, labels_list=labels)
    imgs = rng.normal(size=(batch_size, cfg.vision.image_size, cfg.vision.image_size, 3)
                      ).astype(np.float32)
    return plan, imgs, ids, labels


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def np_noise(noise):
    return [u.numpy() for u in noise]


def _gen_case(seed):
    cfg = _gen_cfg()
    params = _jinit(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    ids = []
    for n in (12, 10):
        row = rng.integers(3, cfg.text.vocab_size, size=(n,)).astype(np.int64)
        row[2] = -200
        ids.append(row)
    plan = plan_batch(ids, cfg.num_image_tokens)
    imgs = rng.normal(size=(2, 56, 56, 3)).astype(np.float32)
    args = [plan.token_ids, plan.is_image, plan.image_slot, plan.valid_len,
            plan.spans.image_start, plan.spans.last_instruct_start,
            plan.spans.last_instruct_end, plan.spans.has_image, imgs]
    return cfg, params, plan, [np.asarray(a) for a in args], rng


def _jax_prefill(cfg, params, plan, args):
    cache = init_tiered_cache(cfg.text, 2, plan.batch, 64, 48, jnp.float32)
    return _jprefill(params, cfg, *[jnp.asarray(a) for a in args], cache)[0]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on the 8 ranks, and the JAX references (computed while the
    ranks run: they need only the inputs)."""
    cases, jax_refs = {}, []

    # sharded prefill + 3 decode steps
    cfg, params, plan, args, _ = _gen_case(0)
    decode = np.asarray([[5, 7]] * 3, np.int64)
    cases["decode"] = ("generation", dict(cfg=port_config(cfg), params=np_tree(params),
                                          prefill_args=args, mesh_shape=MESH,
                                          cache=(2, 64, 48), decode_tokens=decode))

    def decode_ref(cfg=cfg, params=params, plan=plan, args=args):
        state = _jax_prefill(cfg, params, plan, args)
        for toks in decode:
            state = _jdecode(params, cfg, jnp.asarray(toks), state)
        return np.asarray(state.last_logits), np.asarray(state.cache.post.length)
    jax_refs.append(("decode", decode_ref))

    # 3 speculative rounds of [B=2, M=4] candidates
    cfg, params, plan, args, rng = _gen_case(1)
    spec = rng.integers(3, cfg.text.vocab_size, size=(3, 2, 4)).astype(np.int64)
    cases["spec"] = ("generation", dict(cfg=port_config(cfg), params=np_tree(params),
                                        prefill_args=args, mesh_shape=MESH, cache=(2, 64, 48),
                                        spec_tokens=spec))

    def spec_ref(cfg=cfg, params=params, plan=plan, args=args):
        state = _jax_prefill(cfg, params, plan, args)
        accs = []
        for toks in spec:
            state, n_acc, _ = _jspec(
                params, cfg, jnp.asarray(toks, jnp.int32), state, eos_token_id=999)
            accs.append(np.asarray(n_acc))
        return (np.asarray(state.last_logits), np.asarray(state.cache.post.length),
                np.stack(accs))
    jax_refs.append(("spec", spec_ref))

    # train steps against the single-device JAX step: one step; grad
    # accumulation 2 over the same batch; LoRA adapters on every target under
    # lora_mode, B made non-zero so that A has a gradient (the column- and
    # row-parallel layouts of an adapter)
    cfg = _train_cfg()
    plan, imgs, _, _ = train_batch(cfg, 4)
    batch = batch_from_plan(plan, imgs)
    np_batch = [None if f is None else np.asarray(f) for f in batch]
    tau = 1.0
    adapters = np_tree(init_lora_params(jax.random.key(6), cfg.text, rank=4, alpha=8.0))
    rng = np.random.default_rng(6)
    for ad in adapters.values():
        ad["b"] = (rng.normal(size=ad["b"].shape) * 0.02).astype(np.float32)
    runs = {  # name: (params, key, grad_accum_steps, optimizer kwargs)
        "train": (np_tree(_jinit(jax.random.key(0), cfg)),
                  jax.random.key(7), 1, OPT),
        "accum": (np_tree(_jinit(jax.random.key(3), cfg)),
                  jax.random.key(9), 2, OPT),
        "lora": (attach_lora(np_tree(_jinit(jax.random.key(5), cfg)),
                             adapters), jax.random.key(7), 1, dict(OPT, lora_mode=True)),
    }
    for name, (params, key, accum, opt) in runs.items():
        noise = (np_noise(shared_noise(cfg, key, plan.batch, plan.seq_len)) if accum == 1
                 else [np_noise(shared_noise(cfg, k, plan.batch // accum, plan.seq_len))
                       for k in jax.random.split(key, accum)])
        lora = name == "lora"
        cases[name] = ("train_step", dict(
            cfg=port_config(cfg), params=params, batch=np_batch, noise=noise, tau=tau,
            mesh_shape=MESH, opt=opt, accum=accum,
            label_kw=dict(lora_mode=True) if lora else None,
            lora_out=LORA_CHECKED if lora else ()))

        def step_ref(params=params, key=key, accum=accum, opt=opt, lora=lora):
            optimizer = make_optimizer(**opt)
            jp = jax.tree.map(jnp.asarray, params)
            labels = label_params(jp, lora_mode=True) if lora else None
            step = make_train_step(cfg, optimizer, remat=False, grad_accum_steps=accum,
                                   labels=labels)
            p, _, m = step(jp, optimizer.init(jax.tree.map(jnp.asarray, params)), batch, key,
                           jnp.float32(tau))
            layers = p["llm"]["layers"]
            return ({k: float(v) for k, v in m.items()}, np.asarray(layers["q"]),
                    {f"{t}/{k}": np.asarray(layers[f"{t}_lora"][k])
                     for t in (LORA_CHECKED if lora else ()) for k in ("a", "b")})
        jax_refs.append((name, step_ref))

    results, refs = run_ranks(tmp_path_factory.mktemp("mesh8"), WORLD, cases, timeout=400,
                              while_running=lambda: {n: f() for n, f in jax_refs})
    return results, refs


def _rows(ref, data):
    half = ref.shape[0] // MESH[0]
    return ref[data * half:(data + 1) * half]


def test_sharded_prefill_decode_matches_single_device_jax(ranks):
    results, refs = ranks
    logits, post_len = refs["decode"]
    for r, res in enumerate(results):
        got = res["decode"]
        assert got["heads"] == 4, r  # 8 KV heads over tensor = 2
        np.testing.assert_allclose(got["logits"], _rows(logits, got["data"]),
                                   atol=5e-4, rtol=5e-3, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["post_len"], post_len[:, _rows(np.arange(2), got["data"])])


def test_sharded_speculative_rounds_accept_identically(ranks):
    results, refs = ranks
    logits, post_len, acc = refs["spec"]
    for r, res in enumerate(results):
        got = res["spec"]
        sel = _rows(np.arange(2), got["data"])
        np.testing.assert_array_equal(got["acc"], acc[:, sel], err_msg=f"rank {r}")
        np.testing.assert_allclose(got["logits"], logits[sel], atol=5e-4, rtol=5e-3)
        np.testing.assert_array_equal(got["post_len"], post_len[:, sel])


def test_sharded_train_step_matches_single_device_jax(ranks):
    results, refs = ranks
    metrics, q, _ = refs["train"]
    for r, res in enumerate(results):
        got = res["train"]
        np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got["q"], q, rtol=2e-3, atol=2e-5, err_msg=f"rank {r}")
        assert got["tower_same"], r  # the frozen tower, bit for bit
        # ZeRO-3 x tensor: each rank holds a quarter of q
        assert got["q_local_shape"] == (4, 64 // 2, 64 // 2)


def test_grad_norm_equals_optax_global_norm(ranks):
    results, refs = ranks
    for name in ("train", "accum"):
        want = refs[name][0]["grad_norm"]
        for res in results:
            np.testing.assert_allclose(res[name]["metrics"]["grad_norm"], want, rtol=2e-4)


def test_sharded_grad_accumulation_matches_jax(ranks):
    results, refs = ranks
    metrics, q, _ = refs["accum"]
    for r, res in enumerate(results):
        got = res["accum"]
        for k in ("loss", "lm_loss", "image_mask_loss", "output_text_mask_loss"):
            np.testing.assert_allclose(got["metrics"][k], metrics[k], rtol=2e-4, atol=2e-5,
                                       err_msg=k)
        np.testing.assert_allclose(got["q"], q, atol=1e-5, rtol=1e-4, err_msg=f"rank {r}")


def test_sharded_lora_step_matches_single_device_jax(ranks):
    results, refs = ranks
    metrics, _, adapters = refs["lora"]
    for r, res in enumerate(results):
        got = res["lora"]
        np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], metrics["grad_norm"], rtol=2e-4)
        for name, want in adapters.items():
            np.testing.assert_allclose(got["lora"][name], want, rtol=2e-3, atol=2e-5,
                                       err_msg=f"rank {r} {name}")
