"""CLIP ViT vision tower (counterpart of ``dynamic_llava_tpu/models/clip.py``).

Patch embedding is one matmul over flattened patches; only the layers up
to the feature tap run (``select_layer=-2`` runs 23 of 24); attention is
non-causal through kernel K1 on the card, differentiable through K3
(``flash_attention_vjp``: an unfrozen tower gets its gradient on the card as
on the CPU; under ``no_grad`` it is K1 alone).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ClipVisionConfig
from ..ops.flash_attention import flash_attention_vjp
from ..ops.norm import layer_norm


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``[B, H, W, 3] -> [B, N, p*p*3]`` in (row-in-patch, col-in-patch,
    channel) order, the converter's conv-kernel flattening."""
    b, h, w, c = images.shape
    p = patch_size
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def _encoder_layer(lp, cfg: ClipVisionConfig, x: torch.Tensor) -> torch.Tensor:
    b, n, d = x.shape
    nh = cfg.num_attention_heads
    h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
    q = (h @ lp["q_w"] + lp["q_b"]).reshape(b, n, nh, d // nh)
    k = (h @ lp["k_w"] + lp["k_b"]).reshape(b, n, nh, d // nh)
    v = (h @ lp["v_w"] + lp["v_b"]).reshape(b, n, nh, d // nh)
    o = flash_attention_vjp(q, k, v, causal=False).reshape(b, n, d)
    x = x + o @ lp["o_w"] + lp["o_b"]
    h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
    return x + quick_gelu(h @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"] + lp["fc2_b"]


def vision_tower_features(
    params,
    cfg: ClipVisionConfig,
    pixel_values: torch.Tensor,  # [B, H, W, 3] normalized, NHWC
    *,
    select_layer: Optional[int] = None,
    select_feature: Optional[str] = None,
) -> torch.Tensor:
    """Features at the tapped layer: ``[B, N, D]`` (``patch``) or
    ``[B, N+1, D]`` (``cls_patch``)."""
    select_layer = cfg.select_layer if select_layer is None else select_layer
    select_feature = cfg.select_feature if select_feature is None else select_feature
    b = pixel_values.shape[0]
    dtype = params["patch_embedding"].dtype
    x = patchify(pixel_values.to(dtype), cfg.patch_size) @ params["patch_embedding"]
    cls = params["class_embedding"][None, None, :].expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["position_embedding"][None]
    x = layer_norm(x, params["pre_ln"]["w"], params["pre_ln"]["b"], cfg.layer_norm_eps)
    # HF hidden_states[k] is the input of layer k, so tap index L+select
    # (negative select) means running the first L + select + 1 layers
    n_layers = cfg.num_hidden_layers
    n_run = n_layers + select_layer + 1 if select_layer < 0 else select_layer
    layers = params["layers"]
    for i in range(n_run):
        x = _encoder_layer({name: w[i] for name, w in layers.items()}, cfg, x)
    if select_feature == "patch":
        return x[:, 1:]
    if select_feature == "cls_patch":
        return x
    raise ValueError(f"unexpected select_feature: {select_feature}")
