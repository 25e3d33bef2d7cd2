"""Checkpoint weight tools: the port's own copy of
``dynamic_llava_tpu/models/weight_tools.py`` (apply / make a delta, pull
out the projector, merge LoRA, consolidate shards), on torch state dicts.

Every tool reads and writes HF-format directories (``config.json`` +
weights), so its outputs stay usable by the reference implementation. The
arithmetic is fp32 with one rounding to the output's dtype (the delta's,
the target's or the base's): on fp32 files the JAX tools' results bit for
bit, on fp16 / bf16 files theirs rounded to the file's dtype (the JAX tools
write fp32).

    python -m dynamic_llava_tpu_torch.models.weight_tools merge-lora \\
        --model-path LORA_DIR --model-base BASE_DIR --save-model-path OUT_DIR
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, Optional

import torch

from .convert import load_state_dict_from_dir

StateDict = Dict[str, torch.Tensor]


def _save_state_dict(sd: StateDict, out_dir: str, src_dir: Optional[str] = None) -> None:
    """Write a single-shard checkpoint (``model.safetensors`` where the
    ``safetensors`` package imports, else ``pytorch_model.bin``) and copy
    the config and tokenizer files of ``src_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    sd = {k: v.contiguous() for k, v in sd.items()}
    try:
        from safetensors.torch import save_file
    except ImportError:
        torch.save(sd, os.path.join(out_dir, "pytorch_model.bin"))
    else:
        save_file(sd, os.path.join(out_dir, "model.safetensors"))
    if src_dir:
        for f in os.listdir(src_dir):
            if f.endswith((".json", ".model", ".txt")) and not f.startswith("."):
                shutil.copy(os.path.join(src_dir, f), os.path.join(out_dir, f))


def _combine(w: torch.Tensor, other: torch.Tensor, sign: float) -> torch.Tensor:
    """``w + sign * other`` in fp32, rounded once to ``w``'s dtype; where
    ``w`` is larger (an embedding or lm_head grown by added tokens), into
    its leading rows and columns."""
    out = w.to(torch.float32, copy=True)
    rows, cols = other.shape[0], other.shape[1] if other.dim() > 1 else None
    region = out[:rows, :cols] if cols is not None else out[:rows]
    region.add_(other.float(), alpha=sign)
    return out.to(w.dtype)


def apply_delta(base_path: str, target_path: str, delta_path: str) -> None:
    """target = base + delta."""
    base = load_state_dict_from_dir(base_path)
    delta = load_state_dict_from_dir(delta_path)
    out = {name: dw if name not in base else _combine(dw, base[name], 1.0)
           for name, dw in delta.items()}
    _save_state_dict(out, target_path, src_dir=delta_path)


def make_delta(base_path: str, target_path: str, delta_path: str) -> None:
    """delta = target - base."""
    base = load_state_dict_from_dir(base_path)
    target = load_state_dict_from_dir(target_path)
    out = {name: tw if name not in base else _combine(tw, base[name], -1.0)
           for name, tw in target.items()}
    _save_state_dict(out, delta_path, src_dir=target_path)


def extract_mm_projector(model_path: str, output_path: str) -> None:
    """Pull the mm_projector weights out of a full checkpoint."""
    sd = load_state_dict_from_dir(model_path)
    proj = {k: v.contiguous() for k, v in sd.items() if "mm_projector" in k}
    os.makedirs(os.path.dirname(os.path.abspath(output_path)) or ".", exist_ok=True)
    torch.save(proj, output_path)
    print(f"extracted {len(proj)} tensors -> {output_path}")


def merge_lora(base_sd: StateDict, lora_sd: StateDict, scaling: float = 1.0) -> StateDict:
    """Merge peft's LoRA A / B pairs into the base weights: ``W + scaling *
    (B @ A)`` in fp32, rounded once to W's dtype; the adapter file's other
    tensors (non-LoRA trainables) replace the base's."""
    out = dict(base_sd)
    for name, a in lora_sd.items():
        if "lora_A" not in name:
            continue
        b_name = name.replace("lora_A", "lora_B")
        if b_name not in lora_sd:
            continue
        target = (
            name.replace("base_model.model.", "")
            .replace(".lora_A.weight", ".weight")
            .replace(".lora_A.default.weight", ".weight")
        )
        if target not in out:
            continue
        w = out[target]
        out[target] = (w.float() + scaling * (lora_sd[b_name].float() @ a.float())).to(w.dtype)
    for name, w in lora_sd.items():
        if "lora_" not in name:
            out[name.replace("base_model.model.", "")] = w
    return out


def merge_lora_dirs(model_path: str, model_base: str, save_path: str) -> None:
    """Merge an adapter directory into its base (scaling ``lora_alpha / r``
    from ``adapter_config.json``, else 1) and save the merged checkpoint."""
    base = load_state_dict_from_dir(model_base)
    lora = load_state_dict_from_dir(model_path)
    scaling = 1.0
    lora_cfg_path = os.path.join(model_path, "adapter_config.json")
    if os.path.exists(lora_cfg_path):
        with open(lora_cfg_path) as f:
            lc = json.load(f)
        scaling = lc.get("lora_alpha", 16) / lc.get("r", 16)
    _save_state_dict(merge_lora(base, lora, scaling), save_path, src_dir=model_path)


def consolidate(src_path: str, dst_path: str) -> None:
    """Re-save a (possibly sharded) checkpoint as one shard."""
    _save_state_dict(load_state_dict_from_dir(src_path), dst_path, src_dir=src_path)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("apply-delta")
    p.add_argument("--base"); p.add_argument("--target"); p.add_argument("--delta")
    p = sub.add_parser("make-delta")
    p.add_argument("--base"); p.add_argument("--target"); p.add_argument("--delta")
    p = sub.add_parser("extract-mm-projector")
    p.add_argument("--model-path"); p.add_argument("--output")
    p = sub.add_parser("merge-lora")
    p.add_argument("--model-path"); p.add_argument("--model-base")
    p.add_argument("--save-model-path")
    p = sub.add_parser("consolidate")
    p.add_argument("--src"); p.add_argument("--dst")
    args = parser.parse_args(argv)
    if args.cmd == "apply-delta":
        apply_delta(args.base, args.target, args.delta)
    elif args.cmd == "make-delta":
        make_delta(args.base, args.target, args.delta)
    elif args.cmd == "extract-mm-projector":
        extract_mm_projector(args.model_path, args.output)
    elif args.cmd == "merge-lora":
        merge_lora_dirs(args.model_path, args.model_base, args.save_model_path)
    elif args.cmd == "consolidate":
        consolidate(args.src, args.dst)


if __name__ == "__main__":
    main()
