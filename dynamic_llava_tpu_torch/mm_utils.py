"""Image and prompt utilities (host side): the port's own copy of
``dynamic_llava_tpu/mm_utils.py`` (``tests/test_torch_config.py`` holds the
two equal).

Square padding, CLIP preprocessing, anyres tiling, ``tokenizer_image_token``
and the keyword stopping criteria. Images come in as PIL images and leave
as float32 numpy arrays in NHWC layout, the layout ``Generator.generate``
takes. PIL is imported inside the functions that take a PIL image, so the
builder (which makes a ``ClipImagePreprocessor``) loads on a machine
without it.
"""

from __future__ import annotations

import ast
import base64
import math
from io import BytesIO
from typing import List, Optional, Sequence

import numpy as np

from .constants import IMAGE_TOKEN_INDEX

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


# ---------------------------------------------------------------------------
# Basic image ops
# ---------------------------------------------------------------------------


def load_image_from_base64(image: str):
    from PIL import Image

    return Image.open(BytesIO(base64.b64decode(image)))


def expand2square(pil_img, background_color):
    """Pad to square with the dataset-mean background: the image is
    centered on the long side."""
    from PIL import Image

    width, height = pil_img.size
    if width == height:
        return pil_img
    side = max(width, height)
    canvas = Image.new(pil_img.mode, (side, side), background_color)
    canvas.paste(pil_img, ((side - width) // 2, (side - height) // 2))
    return canvas


class ClipImagePreprocessor:
    """Numpy/PIL replica of HF ``CLIPImageProcessor`` for CLIP-L/14-336:
    shortest-edge bicubic resize -> center crop -> rescale 1/255 ->
    normalize. Self-contained (no downloaded processor config needed)."""

    def __init__(
        self,
        size: int = 336,
        crop_size: Optional[int] = None,
        image_mean: Sequence[float] = OPENAI_CLIP_MEAN,
        image_std: Sequence[float] = OPENAI_CLIP_STD,
    ):
        self.size = size
        self.crop_size = crop_size or size
        self.image_mean = tuple(image_mean)
        self.image_std = tuple(image_std)

    def resize_shortest_edge(self, image):
        from PIL import Image

        w, h = image.size
        short, long = (w, h) if w <= h else (h, w)
        if short == self.size:
            return image
        scale = self.size / short
        new_short, new_long = self.size, max(self.size, int(long * scale))
        nw, nh = (new_short, new_long) if w <= h else (new_long, new_short)
        return image.resize((nw, nh), Image.BICUBIC)

    def center_crop(self, image):
        w, h = image.size
        cw = ch = self.crop_size
        left = (w - cw) // 2
        top = (h - ch) // 2
        return image.crop((left, top, left + cw, top + ch))

    def __call__(self, image) -> np.ndarray:
        """-> float32 [H, W, 3] normalized, NHWC per-image."""
        image = image.convert("RGB")
        image = self.resize_shortest_edge(image)
        image = self.center_crop(image)
        arr = np.asarray(image, dtype=np.float32) / 255.0
        mean = np.asarray(self.image_mean, np.float32)
        std = np.asarray(self.image_std, np.float32)
        return (arr - mean) / std

    @property
    def background_color(self):
        """Mean pixel value as uint8 RGB, for expand2square."""
        return tuple(int(x * 255) for x in self.image_mean)


# ---------------------------------------------------------------------------
# anyres tiling (host side; anyres inference is not ported yet)
# ---------------------------------------------------------------------------


def select_best_resolution(original_size, possible_resolutions):
    """Pick the candidate resolution maximizing effective resolution and
    minimizing wasted area."""
    ow, oh = original_size
    best_fit = None
    max_effective = 0
    min_wasted = float("inf")
    for width, height in possible_resolutions:
        scale = min(width / ow, height / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        effective = min(dw * dh, ow * oh)
        wasted = (width * height) - effective
        if effective > max_effective or (
            effective == max_effective and wasted < min_wasted
        ):
            max_effective = effective
            min_wasted = wasted
            best_fit = (width, height)
    return best_fit


def resize_and_pad_image(image, target_resolution):
    from PIL import Image

    ow, oh = image.size
    tw, th = target_resolution
    scale = min(tw / ow, th / oh)
    nw, nh = min(tw, math.ceil(ow * scale)), min(th, math.ceil(oh * scale))
    resized = image.resize((nw, nh))
    canvas = Image.new("RGB", (tw, th), (0, 0, 0))
    canvas.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return canvas


def divide_to_patches(image, patch_size: int) -> list:
    patches = []
    w, h = image.size
    for i in range(0, h, patch_size):
        for j in range(0, w, patch_size):
            patches.append(image.crop((j, i, j + patch_size, i + patch_size)))
    return patches


def _resolutions(grid_pinpoints):
    if isinstance(grid_pinpoints, list):
        return grid_pinpoints
    return ast.literal_eval(grid_pinpoints)


def get_anyres_image_grid_shape(image_size, grid_pinpoints, patch_size):
    width, height = select_best_resolution(image_size, _resolutions(grid_pinpoints))
    return width // patch_size, height // patch_size


def process_anyres_image(image, processor: ClipImagePreprocessor, grid_pinpoints) -> np.ndarray:
    """-> [n_patches+1, H, W, 3]: base global view + tiles."""
    best = select_best_resolution(image.size, _resolutions(grid_pinpoints))
    padded = resize_and_pad_image(image, best)
    patches = divide_to_patches(padded, processor.crop_size)
    global_view = image.resize((processor.size, processor.size))
    return np.stack([processor(p) for p in [global_view] + patches])


# ---------------------------------------------------------------------------
# Batch entry point
# ---------------------------------------------------------------------------


def process_images(
    images: Sequence,
    image_processor: ClipImagePreprocessor,
    model_cfg=None,
    image_aspect_ratio: Optional[str] = None,
) -> np.ndarray:
    """Dispatch on ``image_aspect_ratio`` (default: the model config's).
    Returns [B, H, W, 3] float32 (or a list for anyres with ragged tile
    counts)."""
    if image_aspect_ratio is None:
        image_aspect_ratio = getattr(model_cfg, "image_aspect_ratio", "square")
    out = []
    if image_aspect_ratio == "pad":
        for image in images:
            image = expand2square(
                image.convert("RGB"), image_processor.background_color
            )
            out.append(image_processor(image))
    elif image_aspect_ratio == "anyres":
        grid = getattr(model_cfg, "image_grid_pinpoints", None)
        for image in images:
            out.append(process_anyres_image(image, image_processor, grid))
        if not all(x.shape == out[0].shape for x in out):
            return out
    else:
        for image in images:
            out.append(image_processor(image.convert("RGB")))
    return np.stack(out)


# ---------------------------------------------------------------------------
# Prompt tokenization
# ---------------------------------------------------------------------------


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    return_tensors: Optional[str] = None,
):
    """Tokenize a prompt containing ``<image>`` placeholders, splicing in the
    sentinel ``image_token_index``. A leading BOS from the first chunk is
    preserved; chunk-initial BOS tokens from later chunks are stripped.
    ``return_tensors``: None (a list), ``"np"`` or ``"pt"``."""
    chunks = [tokenizer(c).input_ids for c in prompt.split("<image>")]

    input_ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    merged: List[List[int]] = []
    for i, c in enumerate(chunks):
        merged.append(c)
        if i < len(chunks) - 1:
            merged.append(sep)
    for chunk in merged:
        input_ids.extend(chunk[offset:])

    if return_tensors is None:
        return input_ids
    if return_tensors == "np":
        return np.asarray(input_ids, dtype=np.int32)
    if return_tensors == "pt":
        import torch

        return torch.tensor(input_ids, dtype=torch.long)
    raise ValueError(f"Unsupported tensor type: {return_tensors}")


def get_model_name_from_path(model_path: str) -> str:
    model_path = model_path.strip("/")
    parts = model_path.split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]


class KeywordsStoppingCriteria:
    """Stop generation when any keyword appears at the tail of the generated
    ids. Fed the generated id list per step; ``ChatSession.ask`` matches
    ``keyword_ids`` on the device and keeps this decoded-text test as the
    host's check."""

    def __init__(self, keywords: Sequence[str], tokenizer, input_len: int):
        self.keywords = list(keywords)
        self.keyword_ids: List[List[int]] = []
        self.max_keyword_len = 0
        for kw in self.keywords:
            ids = tokenizer(kw).input_ids
            if len(ids) > 1 and ids[0] == tokenizer.bos_token_id:
                ids = ids[1:]
            self.max_keyword_len = max(self.max_keyword_len, len(ids))
            self.keyword_ids.append(ids)
        self.tokenizer = tokenizer
        self.input_len = input_len

    def __call__(self, output_ids: Sequence[int]) -> bool:
        gen = list(output_ids[self.input_len :])
        for kid in self.keyword_ids:
            if len(gen) >= len(kid) and gen[-len(kid) :] == kid:
                return True
        tail_len = min(self.max_keyword_len + 2, len(gen))
        if tail_len == 0:
            return False
        tail = self.tokenizer.decode(gen[-tail_len:])
        return any(kw in tail for kw in self.keywords)
