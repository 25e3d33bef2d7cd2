"""The training step (counterpart of ``dynamic_llava_tpu/train/step.py``,
single device).

One step: forward (Gumbel policy path) + losses + ``backward()`` + grouped
AdamW update. Activation checkpointing is applied per decoder layer. Where
the JAX step returns new parameters and optimizer state, this one updates
both IN PLACE and returns the same objects.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..config import LlavaConfig
from ..models import dynamic
from ..multimodal.fusion import FusionPlan
from ..weights import named_leaves, trainable_view
from .losses import total_loss
from .optimizer import GroupedAdamW


class TrainBatch(NamedTuple):
    """Device-side training batch (built from a FusionPlan + images)."""

    token_ids: torch.Tensor  # [B, S]
    is_image: torch.Tensor  # [B, S] bool
    image_slot: torch.Tensor  # [B, S]
    labels: torch.Tensor  # [B, S]
    valid_len: torch.Tensor  # [B]
    image_start: torch.Tensor  # [B]
    answer_start: torch.Tensor  # [B]
    answer_end: torch.Tensor  # [B]
    last_instruct_start: torch.Tensor  # [B]
    last_instruct_end: torch.Tensor  # [B]
    has_image: torch.Tensor  # [B] bool
    pixel_values: Optional[torch.Tensor]  # [B, H, W, 3] or None


def batch_from_plan(plan: FusionPlan, pixel_values, device=None) -> TrainBatch:
    sp = plan.spans

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return TrainBatch(
        token_ids=dev(plan.token_ids),
        is_image=dev(plan.is_image),
        image_slot=dev(plan.image_slot),
        labels=dev(plan.labels),
        valid_len=dev(plan.valid_len),
        image_start=dev(sp.image_start),
        answer_start=dev(sp.answer_start),
        answer_end=dev(sp.answer_end),
        last_instruct_start=dev(sp.last_instruct_start),
        last_instruct_end=dev(sp.last_instruct_end),
        has_image=dev(sp.has_image),
        pixel_values=None if pixel_values is None else torch.as_tensor(
            pixel_values).to(device),
    )


def loss_fn(params, cfg: LlavaConfig, batch: TrainBatch, noise, tau, remat=True,
            remat_policy="nothing", fused_ce=True):
    """``(loss, metrics)``. ``fused_ce``: the ``[B, S, V]`` fp32 logits never
    exist; the lm_head and the CE run blockwise inside the loss."""
    out = dynamic.forward_train(
        params, cfg,
        batch.token_ids, batch.is_image, batch.image_slot, batch.valid_len,
        batch.image_start, batch.answer_start, batch.answer_end,
        batch.last_instruct_start, batch.last_instruct_end, batch.has_image,
        batch.pixel_values, noise, tau, remat=remat, remat_policy=remat_policy,
        return_hidden=fused_ce,
    )
    return total_loss(out, batch.labels, cfg.sparse,
                      llm_params=params["llm"], tcfg=cfg.text)


Noise = Union[torch.Generator, Sequence]


def make_train_step(
    cfg: LlavaConfig,
    optimizer: GroupedAdamW,
    remat: bool = True,
    grad_accum_steps: int = 1,
    labels=None,
    remat_policy: str = "nothing",
    fused_ce: bool = True,
):
    """Returns ``step(params, opt_state, batch, noise, tau) -> (params,
    opt_state, metrics)``; ``params`` and ``opt_state`` are updated in
    place. ``noise`` is a ``torch.Generator`` or the uniform tensors of
    ``forward_train`` (with ``grad_accum_steps > 1``, one such triple per
    micro-batch).

    ``grad_accum_steps > 1`` splits the batch's leading dim into that many
    micro-batches and averages their gradients before the update.

    ``labels`` (the optimizer's label tree) restricts differentiation to
    the leaves that are not ``'frozen'``: a frozen weight is a plain tensor
    in the forward and gets no gradient buffer at all, so projector-only
    pretraining allocates no decoder gradients. The gradient buffers live
    as long as the step function and are zeroed at each step."""
    frozen = set()
    if labels is not None:
        frozen = {p for p, label in named_leaves(labels) if label == "frozen"}
    buffers: Dict[str, torch.Tensor] = {}

    def grad_buffers(params) -> Dict[str, torch.Tensor]:
        for path, t in named_leaves(params):
            if path in frozen or not t.is_floating_point():
                continue
            buf = buffers.get(path)
            if buf is None or (buf.shape, buf.dtype, buf.device) != (t.shape, t.dtype, t.device):
                buffers[path] = torch.zeros_like(t)
            else:
                buf.zero_()
        return buffers

    def split(batch: TrainBatch):
        def cut(x):
            if x is None:
                return [None] * grad_accum_steps
            if x.shape[0] % grad_accum_steps:
                raise ValueError(
                    f"batch {x.shape[0]} does not divide into "
                    f"{grad_accum_steps} micro-batches")
            return x.chunk(grad_accum_steps)

        return [TrainBatch(*fields) for fields in zip(*(cut(f) for f in batch))]

    def step(params, opt_state, batch: TrainBatch, noise: Noise, tau):
        grads = grad_buffers(params)
        view = trainable_view(params, grads)
        if grad_accum_steps == 1:
            micro, noises = [batch], [noise]
        else:
            micro = split(batch)
            noises = ([noise] * grad_accum_steps
                      if isinstance(noise, torch.Generator) else list(noise))
        metrics: Dict[str, torch.Tensor] = {}
        for mb, nz in zip(micro, noises):
            loss, m = loss_fn(view, cfg, mb, nz, tau, remat, remat_policy, fused_ce)
            loss.backward()  # accumulates into ``grads`` in place
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach()
        if grad_accum_steps > 1:
            inv = 1.0 / grad_accum_steps
            for g in grads.values():
                g.mul_(inv)
            metrics = {k: v * inv for k, v in metrics.items()}
        del view
        metrics["grad_norm"] = optimizer.update(params, grads, opt_state)
        return params, opt_state, metrics

    return step
