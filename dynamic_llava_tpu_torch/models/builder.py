"""Checkpoint loading: an HF LLaVA / Dynamic-LLaVA directory -> the port's
runtime. The port's own copy of ``dynamic_llava_tpu/models/builder.py``.

``load_pretrained_model`` reads ``config.json`` and the weights, converts
them into the stacked param tree (``convert.py``) on the card, and returns
``(tokenizer, runtime, image_processor, context_len)``, the call shape the
serve and eval entry points expect; an MPT checkpoint (by its
``model_type`` or the model name) gives an ``MptRuntime`` instead. The
LoRA-merge and delta tools are in ``weight_tools.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import NamedTuple, Optional

import torch

from ..config import ClipVisionConfig, LlamaConfig, LlavaConfig, MptConfig, SparseConfig
from ..mm_utils import ClipImagePreprocessor
from ..weights import resolve_device
from . import convert


class LlavaRuntime(NamedTuple):
    """Loaded model bundle: the param tree and its config."""

    params: dict
    cfg: LlavaConfig

    @property
    def config(self) -> LlavaConfig:
        return self.cfg


class MptRuntime(NamedTuple):
    """Loaded MPT-family bundle (a dense baseline). A type of its own: MPT
    params and config do not fit the LLaMA runners, so a misuse fails at
    the type."""

    params: dict  # {"llm": MPT tree, ["vision_tower", "mm_projector"]}
    cfg: MptConfig
    vision: Optional[ClipVisionConfig] = None  # where a tower was loaded

    @property
    def config(self) -> MptConfig:
        return self.cfg


def llava_config_from_hf_dict(d: dict) -> LlavaConfig:
    """Map an HF llava / dynamic_llava ``config.json`` dict onto
    ``LlavaConfig``. The tower's config is ``vision_config`` where the dict
    has one (the port's exporter writes it), else CLIP-L at 336 or 224 by
    the tower's name; ``infer_vision_config_from_sd`` then reads its sizes
    from the weights."""
    sparse_dict = d.get("sparse_config") or {}
    sparse = SparseConfig.from_dict(sparse_dict) if sparse_dict else SparseConfig(
        use_vision_predictor=False, use_text_predictor=False,
        use_output_text_predictor=False, use_instruct_predictor=False,
    )
    select_layer = d.get("mm_vision_select_layer", -2)
    select_feature = d.get("mm_vision_select_feature", "patch")
    tower_name = d.get("mm_vision_tower", "") or ""
    if d.get("vision_config"):
        vision = ClipVisionConfig.from_hf_dict(d["vision_config"], select_layer, select_feature)
    else:
        vision = dataclasses.replace(
            ClipVisionConfig(image_size=336 if "336" in tower_name or not tower_name else 224),
            select_layer=select_layer, select_feature=select_feature)
    return LlavaConfig(
        text=LlamaConfig.from_hf_dict(d),
        vision=vision,
        sparse=sparse,
        mm_projector_type=d.get("mm_projector_type", "linear"),
        mm_vision_select_layer=select_layer,
        mm_vision_select_feature=select_feature,
        image_aspect_ratio=d.get("image_aspect_ratio", "square"),
        mm_use_im_start_end=d.get("mm_use_im_start_end", False),
        mm_use_im_patch_token=d.get("mm_use_im_patch_token", True),
        model_max_length=d.get("max_length", d.get("model_max_length", 2048)),
    )


TOWER_PREFIXES = (
    "model.vision_tower.vision_tower.vision_model.",
    "vision_tower.vision_tower.vision_model.",
    "vision_model.",
)
# an MPT checkpoint hangs the tower and projector under HF MPT's inner
# module, "transformer."
MPT_TOWER_PREFIX = "transformer.vision_tower.vision_tower.vision_model."


def infer_vision_config_from_sd(sd: dict, base: ClipVisionConfig) -> ClipVisionConfig:
    """The tower's sizes read from the weights' shapes. The head count is
    not in the shapes: ``base``'s where ``base`` has the tower's width, else
    hidden / 64 (CLIP's head_dim), as the JAX package reads it."""
    for pref in (TOWER_PREFIXES[0], MPT_TOWER_PREFIX, *TOWER_PREFIXES[1:]):
        pe = sd.get(f"{pref}embeddings.patch_embedding.weight")
        if pe is None:
            continue
        hidden, _, patch, _ = pe.shape
        pos = sd[f"{pref}embeddings.position_embedding.weight"].shape[0]
        n_side = int(round((pos - 1) ** 0.5))
        n_layers = 0
        while f"{pref}encoder.layers.{n_layers}.layer_norm1.weight" in sd:
            n_layers += 1
        fc1 = sd[f"{pref}encoder.layers.0.mlp.fc1.weight"].shape[0]
        if hidden == base.hidden_size:
            heads = base.num_attention_heads
        elif hidden % 64 == 0:
            heads = hidden // 64
        else:
            heads = max(1, base.num_attention_heads * hidden // base.hidden_size)
        return dataclasses.replace(
            base,
            hidden_size=int(hidden),
            intermediate_size=int(fc1),
            num_hidden_layers=n_layers,
            num_attention_heads=int(heads),
            image_size=int(n_side * patch),
            patch_size=int(patch),
        )
    return base


def params_from_state_dict(sd: dict, cfg: LlavaConfig, device=None,
                           dtype: Optional[torch.dtype] = None) -> dict:
    """A whole Dynamic-LLaVA state dict -> the port's param tree on
    ``device`` (default: the card), floating leaves in ``dtype`` (None: the
    file's). The tower may live under any of ``TOWER_PREFIXES``; a
    predictor is converted where the config enables it and the weights
    hold it."""
    device = resolve_device(device)
    params = {"llm": convert.llama_params_from_state_dict(sd, cfg.text, device=device,
                                                           dtype=dtype)}
    for pref in TOWER_PREFIXES:
        if f"{pref}embeddings.class_embedding" in sd:
            params["vision_tower"] = convert.clip_params_from_state_dict(
                sd, cfg.vision, prefix=pref, device=device, dtype=dtype)
            break
    if "model.mm_projector.0.weight" in sd or "model.mm_projector.weight" in sd:
        params["mm_projector"] = convert.projector_params_from_state_dict(
            sd, cfg.mm_projector_type, device=device, dtype=dtype)
    preds = {}
    sp = cfg.sparse
    if sp.use_vision_predictor and any(k.startswith("model.image_score_predictor.") for k in sd):
        preds["image_score_predictor"] = convert.vision_predictor_params_from_state_dict(
            sd, sp, device=device, dtype=dtype)
    for name, used in (("output_text_score_predictor", sp.use_output_text_predictor),
                       ("instruct_score_predictor", sp.use_instruct_predictor)):
        if used and any(k.startswith(f"model.{name}.") for k in sd):
            preds[name] = convert.text_predictor_params_from_state_dict(
                sd, f"model.{name}.", device=device, dtype=dtype)
    if preds:
        params["predictors"] = preds
    return params


class _HandOnce(dict):
    """A state dict that hands each tensor out once and drops it, so that a
    source tensor is freed as soon as its leaf is written."""

    def __getitem__(self, key):
        return self.pop(key)


def load_tokenizer(model_path: str):
    """``transformers.AutoTokenizer`` of the directory, or None where it
    cannot be had, as the JAX builder does: ``transformers`` does not
    import, the directory holds no tokenizer, or its tokenizer class needs
    a package that is missing (a ``LlamaTokenizer`` without
    ``sentencepiece`` raises ``ImportError``). A failure other than a
    missing ``transformers`` is warned about with its type and message."""
    try:
        from transformers import AutoTokenizer
    except ImportError:
        return None
    try:
        return AutoTokenizer.from_pretrained(model_path, use_fast=False)
    except Exception as e:  # any failure means "no tokenizer", as in the JAX builder
        warnings.warn(f"{model_path}: no tokenizer ({type(e).__name__}: {e})", stacklevel=2)
        return None


def _load_mpt_model(model_path: str, model_base: Optional[str], hf_cfg: dict,
                    dtype: torch.dtype, device: torch.device):
    """The MPT route: the decoder through ``mpt.mpt_params_from_state_dict``,
    a LLaVA-MPT checkpoint's tower and projector (under ``transformer.`` or
    ``model.``) through the shared converters; the context length is the
    config's ``max_seq_len``. Returns ``(tokenizer, MptRuntime,
    image_processor, context_len)``."""
    from . import mpt

    cfg = MptConfig.from_hf_dict(hf_cfg)
    tokenizer = load_tokenizer(model_path)
    sd = {}
    for path in (model_base, model_path):
        if path is not None:
            sd.update(convert.load_state_dict_from_dir(path))
    params = {"llm": mpt.mpt_params_from_state_dict(sd, cfg, device=device, dtype=dtype)}
    vision = None
    for pref in (MPT_TOWER_PREFIX, TOWER_PREFIXES[0]):
        if f"{pref}embeddings.class_embedding" in sd:
            vision = infer_vision_config_from_sd(sd, ClipVisionConfig())
            params["vision_tower"] = convert.clip_params_from_state_dict(
                sd, vision, prefix=pref, device=device, dtype=dtype)
            break
    proj_type = hf_cfg.get("mm_projector_type", "linear")
    for pref in ("transformer.mm_projector.", "model.mm_projector."):
        if any(k.startswith(pref) for k in sd):
            params["mm_projector"] = convert.projector_params_from_state_dict(
                sd, proj_type, prefix=pref, device=device, dtype=dtype)
            break
    image_processor = ClipImagePreprocessor(size=(vision or ClipVisionConfig()).image_size)
    return (tokenizer, MptRuntime(params=params, cfg=cfg, vision=vision), image_processor,
            hf_cfg.get("max_seq_len", 2048))


def load_pretrained_model(
    model_path: str,
    model_base: Optional[str] = None,
    model_name: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    tower_path: Optional[str] = None,
    **_: object,
):
    """Returns ``(tokenizer, LlavaRuntime, image_processor, context_len)``,
    the params on ``device`` (default: the card; ``"cpu"`` runs the plain
    versions) with every floating leaf in ``dtype``; for an MPT checkpoint
    (``model_type`` or ``model_name`` naming ``mpt``) the runtime is an
    ``MptRuntime`` and the context length its ``max_seq_len``.

    ``model_base`` serves projector-only and delta checkpoints as the
    reference does: the base's weights, then ``model_path``'s over them.
    ``tower_path`` adds a separately stored CLIP checkpoint directory."""
    device = resolve_device(device)
    with open(os.path.join(model_path, "config.json")) as f:
        hf_cfg = json.load(f)
    model_type = (hf_cfg.get("model_type") or "").lower()
    if "mpt" in model_type or "mpt" in (model_name or "").lower():
        return _load_mpt_model(model_path, model_base, hf_cfg, dtype, device)
    cfg = llava_config_from_hf_dict(hf_cfg)
    # before the weights: a directory whose tokenizer fails costs no load first
    tokenizer = load_tokenizer(model_path)

    sd = {}
    for path in (model_base, model_path, tower_path):
        if path is not None:
            sd.update(convert.load_state_dict_from_dir(path))
    cfg = dataclasses.replace(cfg, vision=infer_vision_config_from_sd(sd, cfg.vision))
    sd = _HandOnce(sd)
    params = params_from_state_dict(sd, cfg, device=device, dtype=dtype)
    del sd

    image_processor = ClipImagePreprocessor(size=cfg.vision.image_size)
    return (tokenizer, LlavaRuntime(params=params, cfg=cfg), image_processor,
            cfg.model_max_length)
