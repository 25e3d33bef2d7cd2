"""GPipe pipeline parallelism over the decoder's layer stack (counterpart of
``dynamic_llava_tpu/parallel/pipeline.py``).

The ``pipe`` mesh axis owns contiguous blocks of the stacked layer
parameters, and microbatches flow stage to stage:

* **Schedule**: classic GPipe, ``M`` microbatches over ``P`` stages in
  ``M + P - 1`` ticks a sweep. At tick ``t`` stage ``p`` runs microbatch
  ``t - p``: stage 0 reads microbatch ``t``, the later stages the carry
  the previous stage sent at tick ``t - 1``; one point-to-point exchange a
  tick moves every stage's output to the next stage. Warm-up and drain
  ticks compute on zeros or stale values that are never emitted.
* **Two sweeps around the sparsification event**: layers
  ``[0, sparse_layer)`` are one sweep, the Gumbel predictors run between
  the sweeps (replicated over ``pipe``), layers ``[sparse_layer, L)`` with
  the policy mask are the second sweep.
* **Layer order**: one permutation of the stacked ``[L, ...]`` parameters
  puts each stage's pre-sweep chunk and post-sweep chunk into its
  contiguous ``L / P`` shard (``plan_pipeline`` / ``permute_stack``), so
  the parameter tree, the optimizer and the checkpoints keep their shapes;
  ``inverse_order`` restores the order for export.
* **The backward**: a plain tick loop under autograd. The exchange is an
  autograd function whose backward sends the gradient to the previous
  stage and receives the next stage's; each tick's send and receive are
  one ``batch_isend_irecv``. Every stage's tick input depends on the
  carried state (``torch.where`` keeps both branches in the graph), so
  every stage runs the exchanges' backwards in reverse tick order, the
  same sequence on all stages. The sweep's inputs (``x`` and the policy
  mask) are the identity forward and summed over ``pipe`` backward; its
  output is the last stage's, summed over ``pipe`` forward (one stage is
  non-zero) and the identity backward, so every stage holds it.

A stage whose chunk in a sweep is shorter than another stage's simply runs
fewer layers; a stage with NO layer in a sweep that carries a policy runs
one masked layer application a tick (its output discarded by a select), so
that the policy reaches that stage's backward and its gradient sum over
``pipe`` is issued by every stage. The waste is zero when ``sparse_layer``
leaves every stage a layer in each sweep.

``torch.distributed.pipelining`` is not used: its schedules own the
backward and expect one forward a step, while the sparse forward makes two
sweeps with the predictors between them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models import llama
from ..weights import map_leaves
from . import sharding
from .sharding import P


class PipePlan(NamedTuple):
    """Static description of one pipeline layout."""

    stages: int
    num_layers: int
    sparse_layer: int
    microbatches: int
    order: tuple  # [L] permuted slot -> original layer index
    n_pre: tuple  # [P] pre-sweep layer count a stage


def plan_pipeline(num_layers: int, sparse_layer: int, stages: int,
                  microbatches: int) -> PipePlan:
    """Stage ``p`` owns permuted slots ``[p*L/P, (p+1)*L/P)``: its pre-sweep
    chunk, then its post-sweep chunk. Pre chunks split ``[0, sparse_layer)``
    as evenly as possible (earlier stages take the remainder); post chunks
    fill the rest of each stage, which keeps the original post order across
    stages."""
    assert stages >= 1 and microbatches >= 1
    assert num_layers % stages == 0, (num_layers, stages)
    per = num_layers // stages
    base, rem = divmod(sparse_layer, stages)
    n_pre = [base + (1 if p < rem else 0) for p in range(stages)]
    assert max(n_pre) <= per, (n_pre, per)
    order = []
    pre_cur, post_cur = 0, sparse_layer
    for p in range(stages):
        order.extend(range(pre_cur, pre_cur + n_pre[p]))
        pre_cur += n_pre[p]
        n_post = per - n_pre[p]
        order.extend(range(post_cur, post_cur + n_post))
        post_cur += n_post
    assert pre_cur == sparse_layer and post_cur == num_layers
    return PipePlan(stages=stages, num_layers=num_layers, sparse_layer=sparse_layer,
                    microbatches=microbatches, order=tuple(order), n_pre=tuple(n_pre))


def inverse_order(order) -> tuple:
    inv = np.empty(len(order), dtype=np.int64)
    inv[np.asarray(order)] = np.arange(len(order))
    return tuple(int(i) for i in inv)


def permute_stack(layers, order):
    """The stacked ``[L, ...]`` layer tree in ``order`` (0-d leaves, the
    LoRA scales, pass through)."""

    def pick(_path, a):
        if a.dim() == 0:
            return a
        return a.index_select(0, torch.as_tensor(order, device=a.device))

    return map_leaves(pick, layers)


def layer_stack_specs(layers):
    """Specs sharding only the stacked layer axis over ``pipe``."""
    return map_leaves(lambda _path, a: P() if a.dim() == 0 else P("pipe"), layers)


# ---------------------------------------------------------------------------
# The pipelined sweep
# ---------------------------------------------------------------------------


def _exchange(x: torch.Tensor, group, idx: int, stages: int, step: int) -> torch.Tensor:
    """Send ``x`` to stage ``idx + step`` and receive from ``idx - step``
    (zeros where there is no such stage), as one batch."""
    out = torch.zeros_like(x)
    ops = []
    if 0 <= idx + step < stages:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, idx + step), group))
    if 0 <= idx - step < stages:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, idx - step), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _Shift(torch.autograd.Function):
    """Forward: every stage's ``x`` to the next stage (``ppermute`` over
    ``[(i, i + 1)]``). Backward: the gradient to the previous stage."""

    @staticmethod
    def forward(ctx, x, group, idx, stages):
        ctx.args = (group, idx, stages)
        return _exchange(x, group, idx, stages, 1)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, *ctx.args, -1), None, None, None


def _sweep(layers_local, x, positions, policy, *, cfg, plan: PipePlan, mesh,
           sweep_pre: bool, remat: bool, remat_policy: str) -> torch.Tensor:
    stages, M = plan.stages, plan.microbatches
    per = plan.num_layers // stages
    idx = mesh.coord("pipe")
    group = mesh.group("pipe")
    n_pre = plan.n_pre[idx]
    start, count = (0, n_pre) if sweep_pre else (n_pre, per - n_pre)
    # a stage without a layer here still runs one (masked) application when
    # a policy rides along, so that the policy's backward sum over 'pipe'
    # is issued on every stage (see the module docstring)
    steps = count if count or policy is None else 1
    ticks = M + stages - 1
    x_mb = x.chunk(M)
    pos_mb = positions.chunk(M)
    pol_mb = None if policy is None else policy.chunk(M)
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == stages - 1, device=x.device)
    masked = torch.tensor(False, device=x.device)
    state = torch.zeros_like(x_mb[0])
    outs = []
    for t in range(ticks):
        m = min(max(t - idx, 0), M - 1)
        h = torch.where(first, x_mb[min(t, M - 1)], state)
        pol = None if pol_mb is None else pol_mb[m]
        for j in range(steps):
            lp = llama.layer_params(layers_local, min(start + j, per - 1))
            if remat and torch.is_grad_enabled():
                y = llama._checkpointed(remat_policy, lp, cfg, h, pos_mb[m], None, pol)
            else:
                y = llama.layer_nocache(lp, cfg, h, pos_mb[m], None, pol)
            # a masked application passes h through; its weights get zeros
            h = y if j < count else torch.where(masked, y, h)
        outs.append(h)
        if t < ticks - 1:  # the last tick's carry is never read
            state = _Shift.apply(h, group, idx, stages)
    # microbatch m completes on the last stage at tick m + P - 1
    out = torch.cat(outs[stages - 1: stages - 1 + M])
    return sharding.reduce(torch.where(last, out, torch.zeros_like(out)), "pipe", mesh)


def make_layer_runner(mesh, plan: PipePlan):
    """A drop-in ``layer_runner`` for ``models.dynamic.forward_train`` (the
    signature of ``llama.run_layers_nocache``) that runs a layer range as
    one GPipe sweep over the ``pipe`` axis of ``mesh``.

    ``params['layers']`` must be in pipeline order
    (``permute_stack(layers, plan.order)``) and sharded with
    ``llama_param_specs(cfg, pipe=True)``. Only the two ranges of the
    dynamic forward are valid: ``[0, sparse_layer)`` and
    ``[sparse_layer, num_layers)``."""

    def runner(params, cfg, x: torch.Tensor, positions: torch.Tensor, *, lo: int = 0,
               hi: Optional[int] = None, mask: Optional[torch.Tensor] = None,
               policy: Optional[torch.Tensor] = None, remat: bool = False,
               remat_policy: str = "nothing") -> torch.Tensor:
        assert mask is None, "pipeline sweeps use plain causal attention"
        hi = cfg.num_hidden_layers if hi is None else hi
        if hi == lo:
            return x
        assert cfg.num_hidden_layers == plan.num_layers
        sweep_pre = lo == 0 and hi == plan.sparse_layer
        assert sweep_pre or (lo == plan.sparse_layer and hi == plan.num_layers), (
            lo, hi, plan.sparse_layer)
        if sweep_pre and max(plan.n_pre) == 0:
            return x
        assert x.shape[0] % plan.microbatches == 0, (x.shape[0], plan.microbatches)
        x = sharding.enter(x, "pipe", mesh)
        if policy is not None:
            policy = sharding.enter(policy, "pipe", mesh)
        return _sweep(params["layers"], x, positions, policy, cfg=cfg, plan=plan, mesh=mesh,
                      sweep_pre=sweep_pre, remat=remat, remat_policy=remat_policy)

    return runner
