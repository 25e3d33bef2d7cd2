"""Alternative vision towers: S2 multi-scale and TokenPacker (counterpart of
``dynamic_llava_tpu/models/towers.py``).

S2 encodes an image at several scales, each cut into tiles of the tower's
resolution, and concatenates the features pooled back to the base grid;
every tile batch runs the CLIP tower, so K1 on the card. TokenPacker taps
several tower layers and packs the patch grid with a point-to-region cross
attention: a coarse query attends only its own ``scale_factor^2`` fine
tokens, a 4-key softmax that stays plain PyTorch as the JAX ``einsum`` stays
outside any kernel. As in the JAX package, neither the builder nor
``prefill`` calls these functions.

The resizes are ``jax.image.resize(..., "bilinear")``, which antialiases
when it downsamples: ``torch.nn.functional.interpolate(mode="bilinear",
antialias=True)`` is the same triangle filter (without ``antialias`` the
24 -> 12 downsample of TokenPacker differs by ~50).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import ClipVisionConfig
from ..ops.norm import layer_norm
from ..weights import _Init, resolve_device
from .clip import _encoder_layer, patchify, vision_tower_features


def _resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """``[B, H, W, C] -> [B, size, size, C]``."""
    x = F.interpolate(images.permute(0, 3, 1, 2).float(), size=(size, size), mode="bilinear",
                      antialias=True, align_corners=False)
    return x.permute(0, 2, 3, 1).to(images.dtype)


def _split_tiles(images: torch.Tensor, tile: int) -> torch.Tensor:
    """``[B, S, S, 3] -> [B*(S/t)^2, t, t, 3]`` in row-major tile order."""
    b, s, _, c = images.shape
    n = s // tile
    x = images.reshape(b, n, tile, n, tile, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * n * n, tile, tile, c)


def _merge_tiles(feats: torch.Tensor, n: int, pps: int) -> torch.Tensor:
    """``[B*n^2, pps^2, D] -> [B, n*pps, n*pps, D]`` spatial map."""
    bn2, _, d = feats.shape
    b = bn2 // (n * n)
    x = feats.reshape(b, n, n, pps, pps, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, n * pps, n * pps, d)


def _avg_pool_to(x: torch.Tensor, out: int) -> torch.Tensor:
    """Average-pool a ``[B, S, S, D]`` map to ``[B, out, out, D]`` (S divisible)."""
    b, s, _, d = x.shape
    k = s // out
    return x.reshape(b, out, k, out, k, d).mean(dim=(2, 4))


def s2_tower_features(
    params,
    cfg: ClipVisionConfig,
    pixel_values: torch.Tensor,  # [B, H, W, 3] at the base scale
    scales: Sequence[int] = (336, 672, 1008),
) -> torch.Tensor:
    """Multi-scale features: each scale tiled to the base resolution,
    encoded (one tower batch of ``B * (scale / base)^2`` tiles), reassembled,
    average-pooled back to the base grid, and concatenated along channels.
    -> ``[B, num_patches, D * len(scales)]``."""
    base = cfg.image_size
    pps = cfg.num_patches_per_side
    b = pixel_values.shape[0]
    outs = []
    for scale in scales:
        imgs = pixel_values if scale == base else _resize_bilinear(pixel_values, scale)
        n = scale // base
        tiles = _split_tiles(imgs, base) if n > 1 else imgs
        feats = vision_tower_features(params, cfg, tiles)  # [B*n^2, pps^2, D]
        grid = _merge_tiles(feats, n, pps)  # [B, n*pps, n*pps, D]
        pooled = _avg_pool_to(grid, pps) if n > 1 else grid
        outs.append(pooled.reshape(b, pps * pps, -1))
    return torch.cat(outs, dim=-1)


def tokenpacker_tower_features(
    params,
    cfg: ClipVisionConfig,
    pixel_values: torch.Tensor,
    multi_layers: Sequence[int] = (12, 16, 22, 23),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(single, multi)``: the patch features at ``cfg.select_layer`` and
    the channel concatenation of the tapped layers' (tap ``i`` is the output
    of layer ``i``, HF's ``hidden_states[i]``)."""
    b = pixel_values.shape[0]
    dtype = params["patch_embedding"].dtype
    x = patchify(pixel_values.to(dtype), cfg.patch_size) @ params["patch_embedding"]
    cls = params["class_embedding"][None, None, :].expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["position_embedding"][None]
    x = layer_norm(x, params["pre_ln"]["w"], params["pre_ln"]["b"], cfg.layer_norm_eps)

    want = set(multi_layers)
    single_idx = (cfg.num_hidden_layers + cfg.select_layer + 1 if cfg.select_layer < 0
                  else cfg.select_layer)
    want.add(single_idx)
    taps = {}
    layers = params["layers"]
    for i in range(max(want)):
        x = _encoder_layer({name: w[i] for name, w in layers.items()}, cfg, x)
        if (i + 1) in want:
            taps[i + 1] = x
    single = taps[single_idx][:, 1:]
    multi = torch.cat([taps[i][:, 1:] for i in multi_layers], dim=-1)
    return single, multi


def init_tokenpacker_params(
    generator: torch.Generator,
    kv_dim: int = 1024,
    multi_dim: int = 4096,
    embed_dim: int = 1024,
    hidden_size: int = 4096,
    num_heads: int = 8,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Random TokenPacker params, the JAX ``init_tokenpacker_params`` tree
    (normal(0, 0.02) weights, zero biases, unit norms), drawn from
    ``generator`` on ``device`` (default: the card)."""
    it = _Init(generator, resolve_device(device), dtype)
    return {
        "q_proj": it.linear(kv_dim, embed_dim, bias=False),
        "k_proj": [it.linear(multi_dim, embed_dim), it.linear(embed_dim, embed_dim)],
        "v_proj": [it.linear(multi_dim, embed_dim), it.linear(embed_dim, embed_dim)],
        "ln_q": it.ln(embed_dim),
        "ln_k": it.ln(embed_dim),
        "ln_v": it.ln(embed_dim),
        # nn.MultiheadAttention: packed in-proj + out-proj
        "attn_in": it.linear(embed_dim, 3 * embed_dim),
        "attn_out": it.linear(embed_dim, embed_dim),
        "mlp": [it.linear(embed_dim, hidden_size), it.linear(hidden_size, hidden_size)],
        "num_heads": num_heads,
    }


def _apply(p, x):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def _mlp2(ps, x):
    return _apply(ps[1], F.gelu(_apply(ps[0], x), approximate="none"))


def tokenpacker_project(
    p,
    single: torch.Tensor,  # [B, G^2 * s^2, kv_dim] (576 at raw_grid 24)
    multi: torch.Tensor,  # [B, G^2 * s^2, multi_dim]
    raw_grid: int = 24,
    scale_factor: int = 2,
) -> torch.Tensor:
    """Point-to-region cross attention: coarse queries (the single-level
    grid bilinearly downsampled) attend only their own ``scale_factor^2``
    region of fine keys / values.
    -> ``[B, (raw_grid / scale_factor)^2, hidden_size]``."""
    b, _, kv_dim = single.shape
    g = raw_grid // scale_factor
    nh = int(p["num_heads"])

    key = layer_norm(_mlp2(p["k_proj"], multi), p["ln_k"]["w"], p["ln_k"]["b"], 1e-6)
    value = layer_norm(_mlp2(p["v_proj"], multi), p["ln_v"]["w"], p["ln_v"]["b"], 1e-6)

    grid = single.reshape(b, raw_grid, raw_grid, kv_dim)
    qgrid = _resize_bilinear(grid, g)
    q = _apply(p["q_proj"], qgrid.reshape(b, g * g, kv_dim))
    q = layer_norm(q, p["ln_q"]["w"], p["ln_q"]["b"], 1e-6)

    d = q.shape[-1]

    def regions(x):  # [B, g, s, g, s, D] -> [B, g^2, s^2, D]
        x = x.reshape(b, g, scale_factor, g, scale_factor, d).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, g * g, scale_factor * scale_factor, d)

    k_r, v_r = regions(key), regions(value)
    # packed qkv in-proj (torch MultiheadAttention semantics)
    wq, wk, wv = torch.chunk(p["attn_in"]["w"], 3, dim=1)
    bq, bk, bv = torch.chunk(p["attn_in"]["b"], 3)
    qh = (q @ wq + bq).reshape(b, g * g, 1, nh, d // nh)
    kh = (k_r @ wk + bk).reshape(b, g * g, -1, nh, d // nh)
    vh = (v_r @ wv + bv).reshape(b, g * g, -1, nh, d // nh)

    logits = torch.einsum("bronh,brsnh->brns", qh.float(), kh.float()) * (d // nh) ** -0.5
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("brns,brsnh->brnh", w, vh.float())
    out = _apply(p["attn_out"], out.reshape(b, g * g, d).to(q.dtype))
    return _mlp2(p["mlp"], out)
