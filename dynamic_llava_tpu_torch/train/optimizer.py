"""Grouped AdamW (counterpart of ``dynamic_llava_tpu/train/optimizer.py``).

The original recipe's optimizer groups: predictor params train at
``predictor_lr`` (2e-4) while the base model trains at the base lr (5e-6),
each split into decay and no-decay (norms and biases) groups; the
projector can have its own lr; the vision tower is frozen. The JAX package
builds this from ``optax.multi_transform`` over a label tree; here the same
labels select the group of each leaf and ``GroupedAdamW`` applies, per
group, optax's chain: clip by the GROUP's own global norm, Adam moments
with bias correction, decoupled weight decay, and the learning rate of the
schedule read at the count before the update:

    g   = g if |g|_group < clip else g / |g|_group * clip
    m   = b1 m + (1 - b1) g;      v = b2 v + (1 - b2) g^2
    p  -= lr(count) * ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p)

with ``t = count + 1``. Parameters and moments are updated IN PLACE; the
moments have the parameters' dtype, the arithmetic is fp32 (a stacked
``[L, ...]`` leaf is updated one layer at a time, so the fp32 temporaries
stay at one layer's size).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Union

import torch

from ..weights import STACKED_PREFIXES, map_leaves, named_leaves

Schedule = Callable[[int], float]


def _is_no_decay(path: str) -> bool:
    """Norm weights and biases are excluded from weight decay."""
    return (
        path.endswith("/b")
        or "ln" in path.split("/")[-1]
        or "_ln" in path
        or "norm" in path
    )


def label_params(
    params,
    lora_mode: bool = False,
    tune_mm_mlp_adapter: bool = False,
    projector_lr_group: bool = False,
) -> Any:
    """A tree like ``params`` of ``'frozen'`` (vision tower) |
    ``'predictor[_nd]'`` | ``'projector[_nd]'`` | ``'base[_nd]'``.

    In ``lora_mode`` only adapters (a/b), predictors and the projector
    train; everything else in the LLM is frozen, adapter scales ('s') too.
    ``tune_mm_mlp_adapter`` is the stage-1 alignment recipe: ONLY the
    mm_projector trains. ``projector_lr_group`` routes the projector to
    its own lr group without freezing anything else."""

    def label(path: str, leaf) -> str:
        nd = "_nd" if _is_no_decay(path) else ""
        if path.startswith("mm_projector"):
            if tune_mm_mlp_adapter or projector_lr_group:
                return "projector" + nd
            return "base" + nd
        if tune_mm_mlp_adapter:
            return "frozen"
        if path.startswith("vision_tower"):
            return "frozen"
        if "_lora" in path:
            return "frozen" if path.endswith("/s") else "base"
        if path.startswith("predictors"):
            return "predictor" + nd
        if lora_mode and path.startswith("llm"):
            return "frozen"
        return "base" + nd

    return map_leaves(label, params)


def _slices(path: str, *tensors: torch.Tensor):
    """The tensors whole, or layer by layer for a stacked leaf."""
    if path.startswith(STACKED_PREFIXES) and tensors[0].dim() >= 3:
        return zip(*tensors)
    return [tensors]


def sum_squares(path: str, g: torch.Tensor) -> torch.Tensor:
    """Sum of squares of a gradient, accumulated in fp32."""
    return sum(torch.linalg.vector_norm(gi, dtype=torch.float32) ** 2
               for (gi,) in _slices(path, g))


class GroupedAdamW:
    """See the module docstring. ``init`` makes the state, ``update``
    applies one step in place and returns the global gradient norm."""

    def __init__(self, groups: Dict[str, Dict[str, Any]], b1: float, b2: float,
                 eps: float, grad_clip: float, label_kwargs: Dict[str, bool]):
        self.groups = groups  # label -> {"lr": float or schedule, "wd": float}
        self.b1, self.b2, self.eps, self.grad_clip = b1, b2, eps, grad_clip
        self.label_kwargs = label_kwargs

    def labels(self, params) -> Dict[str, str]:
        """path -> label, for every leaf."""
        return dict(named_leaves(label_params(params, **self.label_kwargs)))

    def init(self, params) -> Dict[str, Any]:
        """Zero moments for every leaf that is not frozen."""
        labels = self.labels(params)
        train = {p: t for p, t in named_leaves(params) if labels[p] != "frozen"}
        return {
            "count": 0,
            "mu": {p: torch.zeros_like(t) for p, t in train.items()},
            "nu": {p: torch.zeros_like(t) for p, t in train.items()},
        }

    @torch.no_grad()
    def update(self, params, grads: Dict[str, torch.Tensor],
               state: Dict[str, Any]) -> torch.Tensor:
        labels = self.labels(params)
        leaves = dict(named_leaves(params))
        sumsq = {p: sum_squares(p, g) for p, g in grads.items()}
        count = state["count"]
        t = count + 1
        bc1, bc2 = 1.0 - self.b1**t, 1.0 - self.b2**t
        for label, group in self.groups.items():
            paths = [p for p in state["mu"] if labels[p] == label and p in grads]
            if not paths:
                continue
            lr = group["lr"](count) if callable(group["lr"]) else group["lr"]
            div = mul = None
            if self.grad_clip and self.grad_clip > 0:
                norm = torch.sqrt(sum(sumsq[p] for p in paths))
                below = norm < self.grad_clip
                # g / norm * clip when the norm reaches the clip, else g (as g / 1 * 1)
                div = torch.where(below, 1.0, norm)
                mul = torch.where(below, 1.0, self.grad_clip)
            for path in paths:
                for p, g, m, v in _slices(path, leaves[path], grads[path],
                                          state["mu"][path], state["nu"][path]):
                    # fp32 temporaries of one slice, updated in place (copies
                    # even of fp32 tensors: m and v are written back before
                    # the temporaries are consumed)
                    gf, mf, vf, pf = (x.to(torch.float32, copy=True) for x in (g, m, v, p))
                    if div is not None:
                        gf.div_(div).mul_(mul)
                    mf.mul_(self.b1).add_(gf, alpha=1.0 - self.b1)
                    vf.mul_(self.b2).addcmul_(gf, gf, value=1.0 - self.b2)
                    m.copy_(mf)
                    v.copy_(vf)
                    upd = mf.div_(bc1).div_(vf.div_(bc2).sqrt_().add_(self.eps))
                    if group["wd"]:
                        upd.add_(pf, alpha=group["wd"])
                    p.copy_(pf.add_(upd, alpha=-lr))
        state["count"] = t
        return torch.sqrt(sum(sumsq.values()))


def make_optimizer(
    base_lr: float = 5e-6,
    predictor_lr: float = 2e-4,
    weight_decay: float = 0.0,
    predictor_weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    lr_schedule: Optional[Schedule] = None,
    predictor_lr_schedule: Optional[Schedule] = None,
    grad_clip: float = 1.0,
    lora_mode: bool = False,
    tune_mm_mlp_adapter: bool = False,
    projector_lr: Optional[float] = None,
    projector_lr_schedule: Optional[Schedule] = None,
) -> GroupedAdamW:
    base: Union[float, Schedule] = lr_schedule or base_lr
    pred: Union[float, Schedule] = predictor_lr_schedule or predictor_lr
    proj = projector_lr_schedule or projector_lr or lr_schedule or base_lr
    groups = {
        "base": {"lr": base, "wd": weight_decay},
        "base_nd": {"lr": base, "wd": 0.0},
        "predictor": {"lr": pred, "wd": predictor_weight_decay},
        "predictor_nd": {"lr": pred, "wd": 0.0},
        "projector": {"lr": proj, "wd": weight_decay},
        "projector_nd": {"lr": proj, "wd": 0.0},
    }
    return GroupedAdamW(
        groups, b1, b2, eps, grad_clip,
        dict(lora_mode=lora_mode, tune_mm_mlp_adapter=tune_mm_mlp_adapter,
             projector_lr_group=projector_lr is not None
             or projector_lr_schedule is not None),
    )


def cosine_with_warmup(peak_lr: float, total_steps: int,
                       warmup_ratio: float = 0.03) -> Schedule:
    """The original recipe: linear warmup from 0 over 3% of the steps, then
    cosine decay to 0; ``total_steps`` includes the warmup."""
    warmup = max(1, int(total_steps * warmup_ratio))
    decay_steps = total_steps - warmup
    if decay_steps <= 0:
        raise ValueError(f"total_steps {total_steps} must exceed the warmup {warmup}")

    def schedule(step: int) -> float:
        if step < warmup:
            return peak_lr * step / warmup
        frac = min(step - warmup, decay_steps) / decay_steps
        return peak_lr * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


def gumbel_tau_schedule(start_tau: float, end_tau: float, total_steps: int) -> Schedule:
    """Exponential tau annealing per step."""

    def tau(step: int) -> float:
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return math.exp(
            math.log(start_tau) + (math.log(end_tau) - math.log(start_tau)) * frac)

    return tau
