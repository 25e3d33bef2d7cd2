"""Anyres (high-resolution tiling) feature merging: the port's own copy of
``dynamic_llava_tpu/multimodal/anyres.py``'s host code, and its
``encode_images_anyres`` on the port's tower.

Each image is encoded as a global view plus a grid of tower-sized tiles;
the tile features are reassembled into a 2-D patch map, the aspect-ratio
padding is cropped off (``unpad``), an ``image_newline`` column marks row
ends (``spatial_unpad``), and the global view goes first. The merged length
varies per image, so the merge runs on the host (numpy) over the tower's
outputs and feeds the fusion planner per-sample token counts.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..mm_utils import get_anyres_image_grid_shape


def unpad_feature_grid(
    grid: np.ndarray,  # [H_p, W_p, D] patch-feature map of the padded image
    original_size: Tuple[int, int],  # (width, height) of the source image
) -> np.ndarray:
    """Crop the rows or columns of padding that ``resize_and_pad_image``
    added, in feature space."""
    h_p, w_p, _ = grid.shape
    ow, oh = original_size
    aspect_src = ow / oh
    aspect_pad = w_p / h_p
    if aspect_src > aspect_pad:
        # padding was added top/bottom
        scaled_h = int(round(w_p / aspect_src))
        pad = (h_p - scaled_h) // 2
        return grid[pad : h_p - pad]
    scaled_w = int(round(h_p * aspect_src))
    pad = (w_p - scaled_w) // 2
    return grid[:, pad : w_p - pad]


def merge_anyres_features(
    tile_features: np.ndarray,  # [n_tiles+1, n_patch, D]; row 0 = global view
    image_size: Tuple[int, int],  # original (width, height)
    grid_pinpoints,
    tower_image_size: int,
    patches_per_side: int,
    image_newline: np.ndarray,  # [D]
    merge_type: str = "spatial_unpad",
) -> np.ndarray:
    """-> [n_merged_tokens, D]."""
    base = tile_features[0]
    tiles = tile_features[1:]
    if tiles.shape[0] == 0 or merge_type == "flat":
        flat = tile_features.reshape(-1, tile_features.shape[-1])
        return flat

    grid_w, grid_h = get_anyres_image_grid_shape(
        image_size, grid_pinpoints, tower_image_size
    )
    d = tiles.shape[-1]
    p = patches_per_side
    # [gh, gw, p, p, D] -> [gh*p, gw*p, D]
    grid = tiles.reshape(grid_h, grid_w, p, p, d)
    grid = grid.transpose(0, 2, 1, 3, 4).reshape(grid_h * p, grid_w * p, d)
    if "unpad" in merge_type:
        grid = unpad_feature_grid(grid, image_size)
        nl = np.broadcast_to(image_newline, (grid.shape[0], 1, d))
        grid = np.concatenate([grid, nl], axis=1)
    spatial = grid.reshape(-1, d)
    return np.concatenate([base, spatial], axis=0)


def encode_images_anyres(
    params,
    cfg,
    tiles_list: List[np.ndarray],  # per image: [n_tiles+1, H, W, 3] normalized
    image_sizes: Sequence[Tuple[int, int]],
    grid_pinpoints,
    merge_type: str = "spatial_unpad",
) -> List[np.ndarray]:
    """Each image's tiles through the tower and projector on the params'
    device (one batch of ``n_tiles + 1`` an image: K1 on the card), then
    merged on the host. Returns per-image ``[n_tokens_i, D]`` float32
    arrays. ``image_newline`` is the params' leaf where the tree has one,
    else zeros, as in the JAX function."""
    from ..models.dynamic import encode_images

    d = cfg.text.hidden_size
    newline = params.get("image_newline")
    newline = (np.zeros((d,), np.float32) if newline is None
               else newline.detach().float().cpu().numpy())
    device = params["vision_tower"]["patch_embedding"].device
    out = []
    with torch.inference_mode():
        for tiles, size in zip(tiles_list, image_sizes):
            pix = torch.as_tensor(np.asarray(tiles, np.float32)).to(device)
            feats = encode_images(params, cfg, pix).float().cpu().numpy()
            out.append(
                merge_anyres_features(
                    feats,
                    size,
                    grid_pinpoints,
                    cfg.vision.image_size,
                    cfg.vision.num_patches_per_side,
                    newline,
                    merge_type,
                )
            )
    return out
