"""Rotary position embeddings (counterpart of ``dynamic_llava_tpu/ops/rope.py``).

Positions are explicit per-token tensors, so tokens that survive pruning
keep their original phases. Angles are fp32; the angle vector is
duplicated (``cat([f, f])``), not interleaved, matching ``rotate_half``.
Linear and dynamic-NTK scaling are supported.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import LlamaConfig, RopeScalingConfig


def rope_cos_sin(
    positions: torch.Tensor,  # [...] int positions
    head_dim: int,
    theta: float = 10000.0,
    scaling: Optional[RopeScalingConfig] = None,
    max_position_embeddings: int = 4096,
):
    """fp32 cos/sin tables ``([..., head_dim], [..., head_dim])`` for the
    given positions. Dynamic NTK derives the running length per sample from
    the positions (max + 1 over the last axis), clamped below at
    ``max_position_embeddings``."""
    positions = positions.float()
    if scaling is not None and scaling.rope_type == "linear":
        positions = positions / scaling.factor
    exponents = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim
    )
    if scaling is not None and scaling.rope_type == "dynamic":
        seq_len = torch.clamp(
            positions.amax(dim=-1) + 1.0, min=float(max_position_embeddings)
        )
        base = theta * (
            (scaling.factor * seq_len / max_position_embeddings)
            - (scaling.factor - 1)
        ) ** (head_dim / (head_dim - 2))
        inv_freq = 1.0 / (base[..., None] ** exponents)  # [B, head_dim//2]
        freqs = positions[..., None] * inv_freq[..., None, :]
    else:
        inv_freq = 1.0 / (theta**exponents)
        freqs = positions[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    x: torch.Tensor,  # [B, S, H, d]
    positions: torch.Tensor,  # [B, S] original-token positions
    theta: float = 10000.0,
    scaling: Optional[RopeScalingConfig] = None,
    max_position_embeddings: int = 4096,
) -> torch.Tensor:
    """Rotate in fp32 and cast back to x's dtype."""
    cos, sin = rope_cos_sin(
        positions, x.shape[-1], theta=theta, scaling=scaling,
        max_position_embeddings=max_position_embeddings,
    )
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    xf = x.float()
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


def apply_rope_for_config(x: torch.Tensor, positions: torch.Tensor, cfg: LlamaConfig):
    return apply_rope(
        x, positions, theta=cfg.rope_theta, scaling=cfg.rope_scaling,
        max_position_embeddings=cfg.max_position_embeddings,
    )
