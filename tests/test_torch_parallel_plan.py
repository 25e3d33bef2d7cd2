"""The port's parallel layer in this process, without a spawn: the spec
trees of ``dynamic_llava_tpu_torch/parallel/sharding.py`` against the JAX
package's, axis tuple for axis tuple (the tiny config with and without LoRA
adapters, tied and untied, with and without ``pipe``); ``plan_pipeline``,
``inverse_order``, ``permute_stack`` and ``layer_stack_specs`` of
``parallel/pipeline.py`` against JAX's exactly; ``make_mesh``'s ``fsdp=-1``
rule and its assert against JAX's mesh shapes on the 8 virtual devices; and,
on a world-size-1 gloo group, that a quantized tree refuses to shard, that
shards (of torch or numpy trees) gather back bit for bit, and chip_smoke's
phase 9e at a tiny size
(what the card runs at 7B width on NCCL)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

from dynamic_llava_tpu.config import LlavaConfig as JLlavaConfig
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu.parallel import pipeline as jpipe
from dynamic_llava_tpu.parallel import sharding as jshard
from dynamic_llava_tpu.train import lora as jlora
from dynamic_llava_tpu_torch.ops.quant import quantize_llm_params
from dynamic_llava_tpu_torch.parallel import pipeline as tpipe
from dynamic_llava_tpu_torch.parallel import sharding as tshard
from dynamic_llava_tpu_torch.train import lora as tlora
from dynamic_llava_tpu_torch.weights import (
    init_llava_params, map_leaves, named_leaves, params_to_numpy)

import chip_smoke
from test_torch_config import port_config


def _cfgs(tied: bool):
    jcfg = JLlavaConfig.tiny()
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text,
                                                              tie_word_embeddings=tied))
    return jcfg, port_config(jcfg)


def _jax_tuples(specs):
    return jax.tree.map(tuple, specs, is_leaf=lambda s: isinstance(s, PartitionSpec))


def _port_tuples(specs):
    return map_leaves(lambda _path, s: tuple(s), specs)


@pytest.mark.parametrize("pipe", [False, True], ids=["no_pipe", "pipe"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora"])
def test_spec_trees_equal_jax(lora, tied, pipe):
    jcfg, tcfg = _cfgs(tied)
    jparams = jax.eval_shape(lambda k: jdyn.init_llava_params(k, jcfg), jax.random.key(0))
    tparams = init_llava_params(tcfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    if lora:
        jparams = jlora.attach_lora(jparams, jax.eval_shape(
            lambda k: jlora.init_lora_params(k, jcfg.text, rank=4), jax.random.key(1)))
        tparams = tlora.attach_lora(tparams, tlora.init_lora_params(
            tcfg.text, torch.Generator().manual_seed(1), rank=4, device="cpu"))
    want = _jax_tuples(jshard.llava_param_specs(jcfg, jparams, pipe=pipe))
    specs = tshard.llava_param_specs(tcfg, tparams, pipe=pipe)
    got = _port_tuples(specs)
    assert got == want
    assert ("lm_head" in got["llm"]) == (not tied)
    assert any(k.endswith("_lora") for k in got["llm"]["layers"]) == lora
    # the trees mirror the params leaf for leaf
    assert [p for p, _ in named_leaves(specs)] == [p for p, _ in named_leaves(tparams)]
    assert _port_tuples(tshard.llama_param_specs(tcfg.text, pipe=pipe)) == _jax_tuples(
        jshard.llama_param_specs(jcfg.text, pipe=pipe))
    assert _port_tuples(tshard.batch_specs({"a": 0, "b": [0]})) == _jax_tuples(
        jshard.batch_specs({"a": 0, "b": [0]}))


@pytest.mark.parametrize("layout", [(32, 2, 4, 4), (8, 3, 2, 2), (4, 1, 2, 2), (8, 0, 4, 1)])
def test_plan_permutation_and_stack_specs_equal_jax(layout):
    want = jpipe.plan_pipeline(*layout)
    got = tpipe.plan_pipeline(*layout)
    assert tuple(got) == tuple(want)
    assert tpipe.inverse_order(got.order) == jpipe.inverse_order(want.order)
    n = layout[0]
    w = np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3)
    a = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    jtree = {"w": jnp.asarray(w), "lora": {"a": jnp.asarray(a), "s": jnp.float32(0.5)}}
    ttree = {"w": torch.from_numpy(w), "lora": {"a": torch.from_numpy(a),
                                                "s": torch.tensor(0.5)}}
    jperm = jpipe.permute_stack(jtree, want.order)
    tperm = tpipe.permute_stack(ttree, got.order)
    for (path, t), (_, j) in zip(named_leaves(tperm), named_leaves(jax.tree.map(np.asarray,
                                                                                 jperm))):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=path)
    back = tpipe.permute_stack(tperm, tpipe.inverse_order(got.order))
    assert torch.equal(back["w"], ttree["w"]) and torch.equal(back["lora"]["a"],
                                                              ttree["lora"]["a"])
    assert _port_tuples(tpipe.layer_stack_specs(ttree)) == _jax_tuples(
        jpipe.layer_stack_specs(jtree))


@pytest.mark.parametrize("shape", [(2, 2, 2, 1), (1, -1, 1, 1), (2, -1, 2, 1), (1, -1, 2, 2),
                                   (1, -1, 1, 2), (8, 1, 1, 1)])
def test_mesh_shape_rule_equals_jax(shape):
    assert len(jax.devices()) == 8
    want = jshard.make_mesh(*shape).devices.shape
    assert tshard.mesh_shape(8, *shape) == tuple(want)


@pytest.mark.parametrize("shape", [(3, -1, 1, 1), (2, 2, 1, 1), (1, 3, 2, 1)])
def test_mesh_shape_that_does_not_cover_the_ranks_raises_as_jax_asserts(shape):
    with pytest.raises(AssertionError):
        jshard.make_mesh(*shape)
    with pytest.raises(ValueError, match="does not cover the 8 ranks"):
        tshard.mesh_shape(8, *shape)


def test_a_cuda_mesh_without_a_card_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="is_available"):
        tshard.make_mesh(device_type="cuda")


@pytest.fixture
def world1(tmp_path):
    """A world-size-1 gloo group in this process, destroyed after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    yield tshard.make_mesh(1, 1, 1, 1, device_type="cpu")
    dist.destroy_process_group()


def test_shards_gather_back_and_a_quantized_tree_refuses(world1):
    mesh = world1
    cfg = port_config(JLlavaConfig.tiny())
    params = init_llava_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    specs = tshard.llava_param_specs(cfg, params)
    local = tshard.shard_params(params, mesh, specs)
    whole = tshard.gather_params(local, specs, mesh)
    from_numpy = tshard.shard_numpy(params_to_numpy(params), mesh, specs, torch.float32)
    for (path, a), (_, b), (_, c), (_, d) in zip(named_leaves(params), named_leaves(local),
                                                 named_leaves(whole), named_leaves(from_numpy)):
        assert torch.equal(a, c) and torch.equal(a, d), path
        assert b.data_ptr() != a.data_ptr(), path  # shards are new tensors
    quant = quantize_llm_params(init_llava_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                                  torch.float32), bits=8)
    with pytest.raises(ValueError, match="quantized"):
        tshard.shard_params(quant, mesh, tshard.llava_param_specs(cfg, quant))
    assert tshard.active() is None
    with mesh:
        assert tshard.active() is mesh and tshard.data_size() == 1
        assert tshard.local_heads(cfg.text.num_key_value_heads) == cfg.text.num_key_value_heads
    assert tshard.active() is None


def test_chip_smoke_parallel_phase_on_the_cpu():
    """Phase 9e's function at a tiny size on a world-size-1 gloo group: the
    sharded and pipelined steps held to the unsharded one, the sharded
    generation identical (its launch counts are held on the card only)."""
    from dynamic_llava_tpu_torch.config import LlavaConfig

    r = chip_smoke.parallel_phase(torch, "cpu", sizes=dict(
        cfg=LlavaConfig.tiny(), depth=4, train=(2, 40), n_text=20))
    assert r["world_size"] == 1 and r["backend"] == "gloo"
    assert r["holds"]["sharded_vs_unsharded"]["q_max_abs_diff"] == 0.0
    assert all(h["ok"] for h in r["holds"].values())
    inf = r["inference"]
    assert inf["tokens"] and inf["acc"] and inf["next"] and inf["post_len"]
    assert not dist.is_initialized()
