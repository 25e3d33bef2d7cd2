"""The port's param tree -> an HF-format checkpoint directory: the port's
own copy of ``dynamic_llava_tpu/models/export.py``, the inverse of
``convert.py``.

The stacked ``[L, in, out]`` leaves become reference-named ``[out, in]``
tensors, written straight from the torch tensors in their own dtype (a
bf16 tree gives a bf16 file), so a checkpoint made here loads in the
reference implementation and in both packages' builders.

``config.json`` carries every field ``builder.llava_config_from_hf_dict``
reads back, so export -> load gives the exported config: besides the JAX
package's fields, ``tie_word_embeddings``, ``rope_scaling``,
``attention_bias`` and the tower's own ``vision_config`` (its head count
and norm epsilon cannot be read from the weights' shapes).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import torch

from ..config import ClipVisionConfig, LlavaConfig
from .convert import CLIP_LAYER_KEYS, CLIP_LINEARS, LAYER_KEYS, TRANSPOSED

StateDict = Dict[str, torch.Tensor]


def _own(t: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """A tensor with a storage of its own (a slice of a stacked leaf would
    save the whole stack), transposed if asked."""
    return (t.T if transpose else t).clone(memory_format=torch.contiguous_format)


def llama_state_dict(params: dict, prefix: str = "model.") -> StateDict:
    sd: StateDict = {}
    layers = params["layers"]
    for ours, theirs in LAYER_KEYS.items():
        stack = layers[ours]
        for i in range(stack.shape[0]):
            sd[f"{prefix}layers.{i}.{theirs}"] = _own(stack[i], ours in TRANSPOSED)
    sd[f"{prefix}embed_tokens.weight"] = _own(params["embed"])
    sd[f"{prefix}norm.weight"] = _own(params["final_ln"])
    if "lm_head" in params:
        sd["lm_head.weight"] = _own(params["lm_head"], transpose=True)
    return sd


def _ln_sd(p, name) -> StateDict:
    return {f"{name}.weight": _own(p["w"]), f"{name}.bias": _own(p["b"])}


def _lin_sd(p, name) -> StateDict:
    sd = {f"{name}.weight": _own(p["w"], transpose=True)}
    if "b" in p:
        sd[f"{name}.bias"] = _own(p["b"])
    return sd


def projector_state_dict(proj, prefix: str = "model.mm_projector.") -> StateDict:
    if len(proj) == 1:
        return _lin_sd(proj[0], prefix[:-1])
    sd: StateDict = {}
    for i, lp in enumerate(proj):
        sd.update(_lin_sd(lp, f"{prefix}{2 * i}"))
    return sd


def vision_predictor_state_dict(p, prefix: str = "model.image_score_predictor.") -> StateDict:
    sd = {}
    sd.update(_ln_sd(p["down_norm"], f"{prefix}down_mlp.0"))
    sd.update(_lin_sd(p["down"], f"{prefix}down_mlp.1"))
    for i, blk in enumerate(p["blocks"]):
        bp = f"{prefix}transformer.{i}"
        sd.update(_ln_sd(blk["norm1"], f"{bp}.norm1"))
        sd.update(_lin_sd(blk["qkv"], f"{bp}.attn.qkv"))
        sd.update(_lin_sd(blk["proj"], f"{bp}.attn.proj"))
        sd.update(_ln_sd(blk["norm2"], f"{bp}.norm2"))
        sd.update(_lin_sd(blk["fc1"], f"{bp}.mlp.fc1"))
        sd.update(_lin_sd(blk["fc2"], f"{bp}.mlp.fc2"))
    sd.update(_lin_sd(p["out1"], f"{prefix}output_mlp.0"))
    sd.update(_lin_sd(p["out2"], f"{prefix}output_mlp.2"))
    sd.update(_lin_sd(p["out3"], f"{prefix}output_mlp.4"))
    return sd


def text_predictor_state_dict(p, prefix: str) -> StateDict:
    sd = {}
    sd.update(_ln_sd(p["norm"], f"{prefix}output_mlp.0"))
    for i, name in enumerate(("fc1", "fc2", "fc3", "fc4")):
        sd.update(_lin_sd(p[name], f"{prefix}output_mlp.{2 * i + 1}"))
    return sd


def clip_state_dict(params, cfg: ClipVisionConfig,
                    prefix: str = "model.vision_tower.vision_tower.vision_model.") -> StateDict:
    sd: StateDict = {}
    emb = f"{prefix}embeddings."
    sd[f"{emb}class_embedding"] = _own(params["class_embedding"])
    # [kh*kw*in, out] -> conv [out, in, kh, kw]
    p = cfg.patch_size
    sd[f"{emb}patch_embedding.weight"] = _own(
        params["patch_embedding"].reshape(p, p, 3, -1).permute(3, 2, 0, 1))
    sd[f"{emb}position_embedding.weight"] = _own(params["position_embedding"])
    sd.update(_ln_sd(params["pre_ln"], f"{prefix}pre_layrnorm"))
    sd.update(_ln_sd(params["post_ln"], f"{prefix}post_layernorm"))
    lp = params["layers"]
    for i in range(lp["ln1_w"].shape[0]):
        base = f"{prefix}encoder.layers.{i}."
        for ours, theirs in CLIP_LAYER_KEYS.items():
            sd[f"{base}{theirs}.weight"] = _own(lp[f"{ours}_w"][i], ours in CLIP_LINEARS)
            sd[f"{base}{theirs}.bias"] = _own(lp[f"{ours}_b"][i])
    return sd


def checkpoint_state_dict(params: dict, cfg: LlavaConfig) -> StateDict:
    """The whole tree as one reference-named state dict, on the params'
    device and in their dtypes."""
    sd: StateDict = {}
    sd.update(llama_state_dict(params["llm"]))
    if "vision_tower" in params:
        sd.update(clip_state_dict(params["vision_tower"], cfg.vision))
    if "mm_projector" in params:
        sd.update(projector_state_dict(params["mm_projector"]))
    preds = params.get("predictors", {})
    if "image_score_predictor" in preds:
        sd.update(vision_predictor_state_dict(preds["image_score_predictor"]))
    for name in ("output_text_score_predictor", "instruct_score_predictor"):
        if name in preds:
            sd.update(text_predictor_state_dict(preds[name], f"model.{name}."))
    return sd


def hf_config_dict(cfg: LlavaConfig) -> dict:
    """The ``config.json`` of ``cfg``."""
    text, vision = cfg.text, cfg.vision
    rope_scaling = None
    if text.rope_scaling is not None:
        rope_scaling = {"type": text.rope_scaling.rope_type,
                        "factor": text.rope_scaling.factor}
    vision_config = {f.name: getattr(vision, f.name) for f in dataclasses.fields(vision)
                     if f.name not in ("select_layer", "select_feature")}
    return {
        "model_type": "dynamic_llava_llama",
        "architectures": ["DynamicLlavaLlamaForCausalLM"],
        "vocab_size": text.vocab_size,
        "hidden_size": text.hidden_size,
        "intermediate_size": text.intermediate_size,
        "num_hidden_layers": text.num_hidden_layers,
        "num_attention_heads": text.num_attention_heads,
        "num_key_value_heads": text.num_key_value_heads,
        "max_position_embeddings": text.max_position_embeddings,
        "rms_norm_eps": text.rms_norm_eps,
        "rope_theta": text.rope_theta,
        "rope_scaling": rope_scaling,
        "attention_bias": text.attention_bias,
        "tie_word_embeddings": text.tie_word_embeddings,
        "sliding_window": text.sliding_window,
        "mm_projector_type": cfg.mm_projector_type,
        "mm_vision_tower": "openai/clip-vit-large-patch14-336",
        "vision_config": vision_config,
        "mm_vision_select_layer": cfg.mm_vision_select_layer,
        "mm_vision_select_feature": cfg.mm_vision_select_feature,
        "image_aspect_ratio": cfg.image_aspect_ratio,
        "mm_use_im_start_end": cfg.mm_use_im_start_end,
        "mm_use_im_patch_token": cfg.mm_use_im_patch_token,
        "model_max_length": cfg.model_max_length,
        "sparse_config": cfg.sparse.to_dict(),
    }


def export_hf_checkpoint(params: dict, cfg: LlavaConfig, out_dir: str, tokenizer=None) -> None:
    """Write a reference-compatible checkpoint directory: one
    ``pytorch_model.bin`` in the params' dtypes and ``config.json`` (and
    the tokenizer's files, when one is given). ``torch.save`` moves one
    tensor at a time off the card, so the host never holds the whole
    tree."""
    os.makedirs(out_dir, exist_ok=True)
    torch.save(checkpoint_state_dict(params, cfg), os.path.join(out_dir, "pytorch_model.bin"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg), f, indent=2)
    if tokenizer is not None:
        tokenizer.save_pretrained(out_dir)
