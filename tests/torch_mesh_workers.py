"""Rank workers of the port's multi-rank CPU tests
(``tests/test_torch_sharding.py``, ``tests/test_torch_pipeline.py``).

This module imports no jax: the JAX package computes the references in the
pytest process, and each rank is a fresh interpreter
(``python tests/torch_mesh_workers.py DIR RANK WORLD``) that joins a gloo
group through a file in DIR, runs every case of ``DIR/cases.pkl`` (a dict
``name -> (kind, kwargs)`` of numpy inputs and port configs) and writes
``DIR/result_<rank>.pkl`` (``name -> dict`` of numpy results). The parent
starts the ranks with ``run_ranks`` and reads the results back.
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def run_ranks(tmp_dir, world: int, cases: dict, timeout: float = 300.0,
              while_running=None):
    """Run ``cases`` on ``world`` gloo ranks: ``(one result dict a rank,
    while_running())``; ``while_running`` (the JAX references, say) runs
    here while the ranks do. A rank that fails ends the others and raises
    with its log."""
    tmp = Path(tmp_dir)
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(HERE)]),
               OMP_NUM_THREADS="1")
    logs = [open(tmp / f"rank_{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__)), str(tmp), str(r), str(world)],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT, cwd=str(ROOT))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        extra = while_running() if while_running is not None else None
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        text = "\n".join(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                         + (tmp / f"rank_{r}.log").read_text()[-4000:] for r in bad[:2])
        raise AssertionError(f"ranks {bad} failed or timed out after {timeout} s\n{text}")
    results = []
    for r in range(world):
        with open(tmp / f"result_{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results, extra


# -- the cases (run on every rank) ------------------------------------------------------


def _np(t):
    return t.detach().float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()


def _mesh(shape):
    from dynamic_llava_tpu_torch.parallel.sharding import make_mesh

    return make_mesh(*shape, device_type="cpu")


def generation(cfg, params, prefill_args, mesh_shape, cache, decode_tokens=None,
               spec_tokens=None, eos_token_id=999):
    """Sharded ``prefill`` then decode steps (``decode_tokens`` [steps, B])
    or speculative rounds (``spec_tokens`` [rounds, B, M]) on this rank's
    rows."""
    import torch

    from dynamic_llava_tpu_torch.models import dynamic
    from dynamic_llava_tpu_torch.ops.kv_cache import init_tiered_cache
    from dynamic_llava_tpu_torch.parallel.sharding import (
        llava_param_specs, local_rows, shard_numpy)

    mesh = _mesh(mesh_shape)
    local = shard_numpy(params, mesh, llava_param_specs(cfg, params), torch.float32)

    def rows(a):
        return local_rows(torch.from_numpy(np.ascontiguousarray(a)), mesh)

    args = [rows(a) for a in prefill_args]
    accs = []
    with torch.no_grad(), mesh:
        sl, pre, post = cache
        state, _ = dynamic.prefill(local, cfg, *args,
                                   init_tiered_cache(cfg.text, sl, args[0].shape[0], pre, post,
                                                     torch.float32, "cpu"))
        for toks in (decode_tokens if decode_tokens is not None else []):
            state = dynamic.decode_step(local, cfg, rows(toks), state)
        for toks in (spec_tokens if spec_tokens is not None else []):
            state, n_acc, _ = dynamic.decode_speculative_step(local, cfg, rows(toks), state,
                                                              eos_token_id=eos_token_id)
            accs.append(_np(n_acc))
    return {"data": mesh.coord("data"), "logits": _np(state.last_logits),
            "post_len": _np(state.cache.post.length),
            "acc": np.stack(accs) if accs else None,
            "heads": int(state.cache.post.k.shape[3])}


def train_step(cfg, params, batch, noise, tau, mesh_shape, opt, accum=1, pipe_plan=None,
               label_kw=None, lora_out=()):
    """One sharded (and, with ``pipe_plan`` = (stages, microbatches),
    pipelined) train step on the GLOBAL batch; the updated ``q`` gathered
    whole (in the original layer order), and the adapters of ``lora_out``."""
    import torch

    from dynamic_llava_tpu_torch.parallel import pipeline
    from dynamic_llava_tpu_torch.parallel.sharding import (
        gather_leaf, llava_param_specs, shard_params)
    from dynamic_llava_tpu_torch.train import optimizer as topt
    from dynamic_llava_tpu_torch.train.step import TrainBatch, make_train_step
    from dynamic_llava_tpu_torch.weights import params_from_numpy

    mesh = _mesh(mesh_shape)
    full = params_from_numpy(params, "cpu", torch.float32)
    runner = None
    if pipe_plan is not None:
        plan = pipeline.plan_pipeline(cfg.text.num_hidden_layers, cfg.sparse.sparse_layer,
                                      *pipe_plan)
        full["llm"] = dict(full["llm"], layers=pipeline.permute_stack(full["llm"]["layers"],
                                                                      plan.order))
        runner = pipeline.make_layer_runner(mesh, plan)
    specs = llava_param_specs(cfg, full, pipe=pipe_plan is not None)
    local = shard_params(full, mesh, specs)
    tower0 = gather_leaf(local["vision_tower"]["patch_embedding"],
                         specs["vision_tower"]["patch_embedding"], mesh).clone()
    optim = topt.make_optimizer(**opt)
    step = make_train_step(cfg, optim, remat=False, grad_accum_steps=accum,
                           labels=topt.label_params(local, **(label_kw or {})), mesh=mesh,
                           param_specs=specs,
                           layer_runner=runner)
    tb = TrainBatch(*(None if a is None else torch.from_numpy(np.ascontiguousarray(a))
                      for a in batch))

    def tensors(triple):
        return [None if u is None else torch.from_numpy(u) for u in triple]

    nz = tensors(noise) if accum == 1 else [tensors(t) for t in noise]
    local, _, metrics = step(local, optim.init(local), tb, nz, tau)
    q = gather_leaf(local["llm"]["layers"]["q"], specs["llm"]["layers"]["q"], mesh)
    if pipe_plan is not None:
        q = q[list(pipeline.inverse_order(plan.order))]
    tower = gather_leaf(local["vision_tower"]["patch_embedding"],
                        specs["vision_tower"]["patch_embedding"], mesh)
    lora = {f"{t}/{k}": _np(gather_leaf(local["llm"]["layers"][f"{t}_lora"][k],
                                       specs["llm"]["layers"][f"{t}_lora"][k], mesh))
            for t in lora_out for k in ("a", "b")}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "q": _np(q), "lora": lora,
            "tower_same": bool(torch.equal(tower, tower0)),
            "q_local_shape": tuple(local["llm"]["layers"]["q"].shape)}


def sweeps(text_cfg, params, x, positions, policy, layers, sparse_layer, mesh_shape,
           microbatches=2, cotangent=False, dtype="float32", remat=True):
    """The pre sweep ``[0, sl)`` and the post sweep ``[sl, L)`` (with the
    policy) through ``make_layer_runner``; with ``cotangent``, the gradients
    of ``mean(post ** 2)`` (in fp32) w.r.t. the layer weights (whole, in the
    original order) and ``x``."""
    import torch

    from dynamic_llava_tpu_torch.parallel import pipeline
    from dynamic_llava_tpu_torch.parallel.sharding import (
        gather_leaf, llama_param_specs, shard_params)
    from dynamic_llava_tpu_torch.weights import params_from_numpy

    dt = getattr(torch, dtype)
    mesh = _mesh(mesh_shape)
    stages = mesh.size("pipe")
    plan = pipeline.plan_pipeline(layers, sparse_layer, stages, microbatches)
    full = params_from_numpy(params, "cpu", dt)
    full["layers"] = pipeline.permute_stack(full["layers"], plan.order)
    specs = llama_param_specs(text_cfg, pipe=True)
    specs = {k: specs[k] for k in full}
    local = shard_params(full, mesh, specs)
    runner = pipeline.make_layer_runner(mesh, plan)
    tx = torch.from_numpy(x).to(dt)
    pos = torch.from_numpy(positions)
    pol = None if policy is None else torch.from_numpy(policy)
    out = {}
    with mesh:
        if not cotangent:
            with torch.no_grad():
                pre = runner(local, text_cfg, tx, pos, lo=0, hi=sparse_layer)
                post = runner(local, text_cfg, pre, pos, lo=sparse_layer, hi=layers,
                              policy=pol)
            return {"pre": _np(pre), "post": _np(post)}
        for t in local["layers"].values():
            t.requires_grad_(True)
        tx.requires_grad_(True)
        y = runner(local, text_cfg, tx, pos, lo=sparse_layer, hi=layers,
                   policy=pol, remat=remat)
        (y.float() ** 2).mean().backward()
    inv = list(pipeline.inverse_order(plan.order))
    for name, t in local["layers"].items():
        g = gather_leaf(t.grad, specs["layers"][name], mesh)
        out[name] = _np(g[inv])
    out["x"] = _np(tx.grad)
    return out


def trainer_pipeline(cfg, params, ids, labels, images, mesh_shape, out_dir):
    """``Trainer`` in pipeline mode for two steps on the mesh of the
    ``TrainerConfig``, then ``unpermuted_params`` and a resume."""
    import torch

    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
    from dynamic_llava_tpu_torch.parallel import pipeline
    from dynamic_llava_tpu_torch.parallel.sharding import gather_leaf
    from dynamic_llava_tpu_torch.train.trainer import Trainer, TrainerConfig
    from dynamic_llava_tpu_torch.weights import init_llava_params, params_from_numpy

    data, fsdp, tensor, pipe = mesh_shape
    plan = plan_batch(ids, cfg.num_image_tokens, labels_list=labels)
    tc = TrainerConfig(
        output_dir=out_dir, learning_rate=1e-3, predictor_lr=1e-3, num_train_steps=2,
        logging_steps=1, save_steps=2, gradient_checkpointing=False,
        data_parallel=data, fsdp_parallel=-1, tensor_parallel=tensor,
        pipeline_parallel=pipe, pipeline_microbatches=2)
    trainer = Trainer(cfg, params_from_numpy(params, "cpu", torch.float32), tc, device="cpu")
    assert trainer.mesh.shape == dict(zip(("data", "fsdp", "tensor", "pipe"), mesh_shape))
    metrics = trainer.train(iter([(plan, images)] * 2))
    trainer.logger.close()
    up = trainer.unpermuted_params()
    q_spec = trainer.specs["llm"]["layers"]["q"]
    whole_q = gather_leaf(trainer.params["llm"]["layers"]["q"], q_spec, trainer.mesh)
    requeued = pipeline.permute_stack(up["llm"]["layers"], trainer.pipe_plan.order)
    other = init_llava_params(cfg, torch.Generator().manual_seed(9), "cpu", torch.float32)
    trainer2 = Trainer(cfg, other, tc, device="cpu")
    resumed = trainer2.maybe_resume()
    same = [name for name, a in trainer.params["llm"]["layers"].items()
            if torch.equal(a, trainer2.params["llm"]["layers"][name])]
    return {"loss": metrics.get("loss", float("nan")), "order": trainer.pipe_plan.order,
            "unpermuted_q": _np(up["llm"]["layers"]["q"]),
            "requeue_exact": bool(torch.equal(requeued["q"], whole_q)),
            "resumed": resumed, "step2": trainer2.step,
            "same_layers": sorted(same), "layers": sorted(trainer.params["llm"]["layers"]),
            "moments_same": all(torch.equal(trainer.opt_state["mu"][p],
                                            trainer2.opt_state["mu"][p])
                                for p in trainer.opt_state["mu"])}


CASES = {"generation": generation, "train_step": train_step, "sweeps": sweeps,
         "trainer_pipeline": trainer_pipeline}


def main(tmp: str, rank: int, world: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    with open(os.path.join(tmp, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    out = {name: CASES[kind](**kwargs) for name, (kind, kwargs) in cases.items()}
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
