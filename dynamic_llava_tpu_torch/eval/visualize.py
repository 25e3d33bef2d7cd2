"""Visualize which image patches the vision predictor kept: the port's
counterpart of ``dynamic_llava_tpu/eval/visualize.py`` (the reference's
``llava/dynamic_eval/visualize.py``). It runs a prefill, reads the keep
mask from ``PrefillInfo.image_keep_mask`` (no forward hooks: the
functional API returns it), reshapes it to the patch grid (24x24 at
336 px) and saves the image with the dropped patches blacked out.

    python -m dynamic_llava_tpu_torch.eval.visualize --model-path CKPT_DIR \\
        --image-file IMAGE --output kept.png [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .model_vqa_loader import add_device_flag


def keep_mask_to_grid(info, plan, num_patches_per_side: int) -> np.ndarray:
    """[B, S] keep mask over fused slots -> [B, P, P] patch grid."""
    mask = info.image_keep_mask.cpu().numpy()
    n = num_patches_per_side * num_patches_per_side
    grids = []
    for i in range(plan.batch):
        start = int(plan.spans.image_start[i])
        grids.append(mask[i, start : start + n].reshape(
            num_patches_per_side, num_patches_per_side))
    return np.stack(grids)


def apply_patch_mask(image: np.ndarray, grid: np.ndarray, patch_px: int) -> np.ndarray:
    """Black out dropped patches on an [H, W, 3] uint8 image."""
    out = image.copy()
    p = patch_px
    for r in range(grid.shape[0]):
        for c in range(grid.shape[1]):
            if not grid[r, c]:
                out[r * p : (r + 1) * p, c * p : (c + 1) * p] = 0
    return out


def visualize(args, loaded=None):
    """Save ``args.output``; returns ``(grid [P, P] bool, masked [H, W, 3]
    uint8)``. ``loaded`` is ``load_pretrained_model``'s tuple where the
    caller has loaded the model already."""
    from PIL import Image

    from ..constants import DEFAULT_IMAGE_TOKEN
    from ..conversation import conv_templates
    from ..generation.generate import GenerationConfig, Generator
    from ..mm_utils import expand2square, process_images, tokenizer_image_token
    from ..models.builder import load_pretrained_model
    from ..multimodal.fusion import plan_batch
    from .self_ppl import prefill_state

    if loaded is None:
        loaded = load_pretrained_model(args.model_path, device=args.device)
    tokenizer, runtime, image_processor, _ = loaded
    conv = conv_templates[args.conv_mode].copy()
    conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + args.query)
    conv.append_message(conv.roles[1], None)
    ids = np.asarray(tokenizer_image_token(conv.get_prompt(), tokenizer), np.int64)

    image = Image.open(args.image_file).convert("RGB")
    pixels = process_images([image], image_processor, runtime.cfg)
    gen = Generator(runtime.params, runtime.cfg, GenerationConfig())
    plan = plan_batch([ids], runtime.cfg.num_image_tokens)
    with torch.inference_mode():
        _, info = prefill_state(gen, plan, pixels, 8)
    if info.image_keep_mask is None:
        raise SystemExit("vision predictor is disabled in this checkpoint")

    pps = runtime.cfg.vision.num_patches_per_side
    grid = keep_mask_to_grid(info, plan, pps)[0]
    kept = int(grid.sum())
    print(f"kept {kept}/{grid.size} image tokens ({kept / grid.size:.1%})")

    vis_img = expand2square(image, image_processor.background_color).resize(
        (runtime.cfg.vision.image_size,) * 2
    )
    masked = apply_patch_mask(np.asarray(vis_img), grid, runtime.cfg.vision.patch_size)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)) or ".", exist_ok=True)
    Image.fromarray(masked).save(args.output)
    print(f"saved {args.output}")
    return grid, masked


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", dest="model_path", required=True)
    p.add_argument("--image-file", dest="image_file", required=True)
    p.add_argument("--query", type=str, default="Describe the image.")
    p.add_argument("--output", type=str, default="visualize_out.png")
    p.add_argument("--conv-mode", dest="conv_mode", default="vicuna_v1")
    return add_device_flag(p)


def main(argv=None):
    return visualize(parser().parse_args(argv))


if __name__ == "__main__":
    main()
