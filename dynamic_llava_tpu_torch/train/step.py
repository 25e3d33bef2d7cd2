"""The training step (counterpart of ``dynamic_llava_tpu/train/step.py``).

One step: forward (Gumbel policy path) + losses + ``backward()`` + grouped
AdamW update. Activation checkpointing is applied per decoder layer. Where
the JAX step returns new parameters and optimizer state, this one updates
both IN PLACE and returns the same objects.

With a mesh (``parallel.sharding``) the parameters are each rank's local
shards, the step takes the GLOBAL batch on every rank and runs its own rows
of each micro-batch (``shard_batch``), the Gumbel noise is drawn for the
global batch from the same generator on every rank (so the sharded step
sees the noise the single-device step sees), the gradients are summed over
``data`` after the backward, and the optimizer's norms are those of the
whole leaves.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..config import LlavaConfig
from ..models import dynamic
from ..multimodal.fusion import FusionPlan
from ..ops.gumbel import uniform_noise
from ..parallel import sharding
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


def shard_batch(batch: TrainBatch, mesh) -> TrainBatch:
    """This rank's rows of a global batch: every field's leading dim split
    over ``data`` (the JAX ``shard_batch`` with ``batch_specs``)."""
    return TrainBatch(*(sharding.local_rows(f, mesh) for f in batch))


def draw_noise(generator: torch.Generator, cfg: LlavaConfig, batch: TrainBatch) -> list:
    """The uniform tensors ``forward_train`` would draw from ``generator``
    for ``batch``, drawn here, in its order and shapes (None for a predictor
    that is off)."""
    sp = cfg.sparse
    b, s = batch.token_ids.shape
    dev = batch.token_ids.device
    vision = sp.use_vision_predictor and batch.pixel_values is not None
    shapes = [(b, cfg.num_image_tokens, 2) if vision else None,
              (b, s, 2) if sp.use_output_text_predictor else None,
              (b, s, 2) if sp.use_instruct_predictor else None]
    return [None if shape is None else uniform_noise(generator, shape, dev)
            for shape in shapes]


def loss_fn(params, cfg: LlavaConfig, batch: TrainBatch, noise, tau, remat=True,
            remat_policy="nothing", fused_ce=True, layer_runner=None):
    """``(loss, metrics)``. ``fused_ce``: the ``[B, S, V]`` fp32 logits never
    exist; the lm_head and the CE run blockwise inside the loss."""
    out = dynamic.forward_train(
        params, cfg,
        batch.token_ids, batch.is_image, batch.image_slot, batch.valid_len,
        batch.image_start, batch.answer_start, batch.answer_end,
        batch.last_instruct_start, batch.last_instruct_end, batch.has_image,
        batch.pixel_values, noise, tau, remat=remat, remat_policy=remat_policy,
        return_hidden=fused_ce, layer_runner=layer_runner,
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
    mesh=None,
    param_specs=None,
    layer_runner=None,
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
    pretraining allocates no decoder gradients, and a LoRA run
    (``lora_mode``) none for its base. A quantized weight (its int8 / int4
    values and its scales) and a LoRA scale never train, labels or not.
    The gradient buffers live as long as the step function and are zeroed
    at each step; ``step.grad_buffers`` holds them (path -> gradient of
    the last step, after the optimizer's update).

    ``mesh`` (a ``parallel.sharding.Mesh``) with ``param_specs`` (the spec
    tree ``params`` was sharded with) makes the step a sharded one: see the
    module docstring; ``noise`` then stands for the GLOBAL batch.
    ``layer_runner`` replaces how the decoder's two layer ranges run
    (``parallel.pipeline.make_layer_runner``)."""
    if mesh is not None:
        if param_specs is None:
            raise ValueError("a sharded step needs the param_specs its params were sharded with")
        sharding.check_heads(cfg.text, mesh)
        specs_of = sharding.specs_by_path(param_specs)
    frozen = set()
    if labels is not None:
        frozen = {p for p, label in named_leaves(labels) if label == "frozen"}
    buffers: Dict[str, torch.Tensor] = {}

    def grad_buffers(params) -> Dict[str, torch.Tensor]:
        leaves = dict(named_leaves(params))
        fixed = {p for p in leaves if p.endswith("_lora/s")} | {
            p.rsplit("/", 1)[0] + "/s" for p, t in leaves.items()
            if p.endswith(("/q", "/q4")) and not t.is_floating_point()}
        for path, t in leaves.items():
            if path in frozen or path in fixed or not t.is_floating_point():
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
            if mesh is not None:
                if isinstance(nz, torch.Generator):
                    nz = draw_noise(nz, cfg, mb)
                nz = [sharding.local_rows(u, mesh) for u in nz]
                mb = shard_batch(mb, mesh)
            loss, m = loss_fn(view, cfg, mb, nz, tau, remat, remat_policy, fused_ce,
                              layer_runner)
            loss.backward()  # accumulates into ``grads`` in place
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach()
        update_kw = {}
        if mesh is not None:
            sharding.reduce_grads(grads, mesh)
            update_kw["reduce_sumsq"] = lambda sumsq: sharding.reduce_sumsq(
                sumsq, specs_of, mesh)
        if grad_accum_steps > 1:
            inv = 1.0 / grad_accum_steps
            for g in grads.values():
                g.mul_(inv)
            metrics = {k: v * inv for k, v in metrics.items()}
        del view
        metrics["grad_norm"] = optimizer.update(params, grads, opt_state, **update_kw)
        return params, opt_state, metrics

    def sharded_step(params, opt_state, batch: TrainBatch, noise: Noise, tau):
        with mesh:  # the backward's recomputations gather under it too
            return step(params, opt_state, batch, noise, tau)

    out = step if mesh is None else sharded_step
    out.grad_buffers = buffers
    return out
