"""Gumbel-softmax with straight-through hard sampling (counterpart of
``dynamic_llava_tpu/ops/gumbel.py``).

``F.gumbel_softmax(logits, tau, hard=True)`` written out so that the noise
can come from outside: every function takes either a ``torch.Generator``
(the trainer's way) or the uniform noise ``u`` itself, in ``(0, 1)`` and of
the logits' shape. With the same ``u`` the result equals the JAX
function's, which draws ``u`` from its key. Runs in fp32 for bf16 training
stability.
"""

from __future__ import annotations

from typing import Union

import torch

Noise = Union[torch.Generator, torch.Tensor]

_TINY = torch.finfo(torch.float32).tiny


def uniform_noise(noise: Noise, shape, device) -> torch.Tensor:
    """``u`` in ``[tiny, 1)`` fp32: drawn from a generator (which must live
    on ``device``), or the given tensor checked against ``shape``."""
    if isinstance(noise, torch.Generator):
        u = torch.rand(shape, generator=noise, device=device, dtype=torch.float32)
        return u.clamp_(min=_TINY)
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(
            f"uniform noise has shape {tuple(noise.shape)}, the logits {tuple(shape)}"
        )
    return noise.to(device=device, dtype=torch.float32)


def _straight_through(y_soft: torch.Tensor) -> torch.Tensor:
    """Forward the one-hot argmax, backward the soft sample."""
    idx = y_soft.argmax(dim=-1, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(-1, idx, 1.0)
    return y_hard + y_soft - y_soft.detach()


def gumbel_softmax(
    noise: Noise,
    logits: torch.Tensor,  # [..., C]
    tau: Union[float, torch.Tensor],
    hard: bool = True,
) -> torch.Tensor:
    logits = logits.float()
    u = uniform_noise(noise, logits.shape, logits.device)
    g = -torch.log(-torch.log(u))
    y_soft = torch.softmax((logits + g) / tau, dim=-1)
    return _straight_through(y_soft) if hard else y_soft


def gumbel_keep_mask(
    noise: Noise,
    logits: torch.Tensor,  # [..., 2]: channel 0 = keep, channel 1 = drop
    tau: Union[float, torch.Tensor],
) -> torch.Tensor:
    """Hard straight-through keep mask in [0, 1] (channel 0 of the one-hot
    sample)."""
    return gumbel_softmax(noise, logits, tau, hard=True)[..., 0]


def ste_argmax_keep(logits: torch.Tensor) -> torch.Tensor:
    """Deterministic straight-through argmax keep decision."""
    return _straight_through(torch.softmax(logits.float(), dim=-1))[..., 0]
