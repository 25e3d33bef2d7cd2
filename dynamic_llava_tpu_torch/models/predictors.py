"""Keep/drop predictor networks (counterpart of
``dynamic_llava_tpu/models/predictors.py``).

Their GELUs are ``jax.nn.gelu`` with its default ``approximate=True``: the
tanh form, ``F.gelu(x, approximate="tanh")`` here, not torch's exact
default. The ViT blocks' attention (576 tokens, 8 heads of 64) is plain
attention, as it is XLA (no Pallas kernel) in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import SparseConfig
from ..ops.attention import attend
from ..ops.norm import layer_norm


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _linear(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def vit_block(p, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = x.shape
    h = layer_norm(x, p["norm1"]["w"], p["norm1"]["b"])
    qkv = _linear(p["qkv"], h).reshape(b, n, 3, num_heads, c // num_heads)
    o = attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(b, n, c)
    x = x + _linear(p["proj"], o)
    h = layer_norm(x, p["norm2"]["w"], p["norm2"]["b"])
    return x + _linear(p["fc2"], _gelu(_linear(p["fc1"], h)))


def vision_predictor(
    p,
    x: torch.Tensor,  # [B, N, D] image-token hidden states at the sparse layer
    sparse: SparseConfig,
    image_policy: Optional[torch.Tensor] = None,  # [B, N, 1] soft keep mask
) -> torch.Tensor:
    """2-class logits ``[B, N, 2]`` (channel 0 = keep)."""
    if image_policy is None:
        image_policy = torch.ones(x.shape[:2] + (1,), dtype=torch.float32,
                                  device=x.device)
    h = layer_norm(x, p["down_norm"]["w"], p["down_norm"]["b"])
    h = _gelu(_linear(p["down"], h))
    pol = image_policy.to(h.dtype)
    h = h * pol
    for blk in p["blocks"]:
        h = vit_block(blk, h, sparse.nhead)
    c = h.shape[-1]
    local = h[:, :, : c // 2]
    glob = (h[:, :, c // 2:] * pol).sum(dim=1, keepdim=True) / pol.sum(
        dim=1, keepdim=True
    )
    h = torch.cat([local, glob.expand(-1, h.shape[1], -1)], dim=-1)
    h = _gelu(_linear(p["out1"], h))
    h = _gelu(_linear(p["out2"], h))
    return _linear(p["out3"], h)


def text_predictor(p, x: torch.Tensor) -> torch.Tensor:
    """Per-token keep/drop logits ``[..., 2]`` (channel 0 = keep)."""
    h = layer_norm(x, p["norm"]["w"], p["norm"]["b"])
    h = _gelu(_linear(p["fc1"], h))
    h = _gelu(_linear(p["fc2"], h))
    h = _gelu(_linear(p["fc3"], h))
    return _linear(p["fc4"], h)
