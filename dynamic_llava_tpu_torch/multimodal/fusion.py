"""Device-side embedding fusion (counterpart of
``dynamic_llava_tpu/multimodal/fusion.py:fuse_embeddings``).

Host-side planning is numpy and is reused from the JAX package
(``plan_batch``, ``FusionPlan``); importing it does not load jax.
"""

from __future__ import annotations

import torch

from dynamic_llava_tpu.multimodal.fusion import FusionPlan, plan_batch  # noqa: F401


def fuse_embeddings(
    text_embeds: torch.Tensor,  # [B, S, D] embedding lookup of plan.token_ids
    image_features: torch.Tensor,  # [B, N_img, D] projected tower output
    plan_is_image: torch.Tensor,  # [B, S] bool
    plan_image_slot: torch.Tensor,  # [B, S] index into the image-feature axis
) -> torch.Tensor:
    """Projected image features at image slots, text embeddings elsewhere."""
    b = text_embeds.shape[0]
    bidx = torch.arange(b, device=text_embeds.device)[:, None]
    img = image_features[bidx, plan_image_slot.long()]  # [B, S, D]
    return torch.where(plan_is_image[:, :, None], img.to(text_embeds.dtype), text_embeds)
