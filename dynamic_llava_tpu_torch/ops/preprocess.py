"""Image preprocessing on the device (counterpart of
``dynamic_llava_tpu/ops/preprocess.py``): pad to square on the dataset-mean
background, bicubic resize to the tower's resolution, CLIP normalization,
for uint8 ``[H, W, 3]`` frames, so raw frames travel to the card instead of
fp32 pixels (4x fewer bytes).

The JAX graph resizes with ``jax.image.resize(..., "cubic", antialias=True)``:
the Keys cubic with a = -0.5, its support widened by the scale when it
downsamples. ``torch.nn.functional.interpolate(mode="bicubic",
antialias=True)`` is that same filter; without ``antialias`` PyTorch
samples a = -0.75 at the source pitch and differs by up to 151 on the
0-255 scale at 480x640 -> 336. The PIL pipeline in ``mm_utils`` stays the
reference of record; the tests hold this one to the JAX graph and to PIL.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..mm_utils import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
from ..weights import resolve_device


def _as_frames(images, device) -> torch.Tensor:
    """A tensor stays where it is; anything else goes to ``device``
    (default: the card)."""
    if isinstance(images, torch.Tensor):
        return images
    return torch.from_numpy(np.ascontiguousarray(images)).to(resolve_device(device))


def preprocess_batch(
    images,  # [B, H, W, 3] uint8, one source size
    out_size: int = 336,
    mode: str = "pad",  # "pad": pad to square first; "square": resize directly
    image_mean: Tuple[float, ...] = OPENAI_CLIP_MEAN,
    image_std: Tuple[float, ...] = OPENAI_CLIP_STD,
    device=None,
) -> torch.Tensor:
    """-> ``[B, out_size, out_size, 3]`` float32, normalized (NHWC), on the
    frames' device."""
    x = _as_frames(images, device)
    b, h, w, _ = x.shape
    mean = torch.tensor(image_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(image_std, dtype=torch.float32, device=x.device)
    x = x.to(torch.float32)
    if mode == "pad" and h != w:
        side = max(h, w)
        canvas = torch.round(mean * 255.0).expand(b, side, side, 3).clone()
        top, left = (side - h) // 2, (side - w) // 2
        canvas[:, top:top + h, left:left + w] = x
        x = canvas
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(out_size, out_size), mode="bicubic",
                      antialias=True, align_corners=False).permute(0, 2, 3, 1)
    # PIL rounds resampled values back into uint8's range before normalizing
    x = torch.clamp(x, 0.0, 255.0) / 255.0
    return (x - mean) / std


def preprocess_image(
    image,  # [H, W, 3] uint8
    out_size: int = 336,
    mode: str = "pad",
    image_mean: Tuple[float, ...] = OPENAI_CLIP_MEAN,
    image_std: Tuple[float, ...] = OPENAI_CLIP_STD,
    device=None,
) -> torch.Tensor:
    """-> ``[out_size, out_size, 3]`` float32, normalized (NHWC)."""
    x = _as_frames(image, device)
    return preprocess_batch(x[None], out_size, mode, image_mean, image_std)[0]
