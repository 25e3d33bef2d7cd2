"""HF checkpoint -> the port's param tree: the port's own copy of
``dynamic_llava_tpu/models/convert.py``.

Linear weights are transposed once here (HF stores ``[out, in]``; the port
computes ``x @ W`` with ``[in, out]``) and per-layer tensors are stacked
along a leading layer axis. The conversion is layout only: transposes,
stacks and one reshape, no arithmetic. Each leaf is written once, straight
from the file's tensor, on ``device`` (default: the card,
``weights.resolve_device``) and in ``dtype`` (None: the file's own), so a
7B checkpoint never passes through fp32 on the host. A cast rounds to
nearest even, as the JAX package's ``jnp.asarray(a, dtype)`` of the fp32
array does (an fp16 value is exact in fp32, so one rounding either way).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

import torch

from ..config import ClipVisionConfig, LlamaConfig, SparseConfig
from ..weights import resolve_device

StateDict = Dict[str, torch.Tensor]


def _put(t: torch.Tensor, device, dtype, transpose: bool = False,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``t`` (transposed) on ``device`` in ``dtype`` (None: ``t``'s), as a
    new contiguous tensor or into ``out``: one move in the file's dtype,
    then one copy that transposes and casts on the device."""
    t = t.to(device)
    if transpose:
        t = t.T
    if out is None:
        out = torch.empty(t.shape, device=device, dtype=dtype or t.dtype)
    return out.copy_(t)


def _stack(sd: StateDict, keys: List[str], device, dtype, transpose: bool = False):
    """The tensors of ``keys`` stacked on a new leading axis; each source is
    read once, straight into its slice."""
    out = None
    for i, key in enumerate(keys):
        t = sd[key]
        if out is None:
            shape = t.shape[::-1] if transpose else t.shape
            out = torch.empty((len(keys), *shape), device=device, dtype=dtype or t.dtype)
        _put(t, device, dtype, transpose, out=out[i])
    return out


# ---------------------------------------------------------------------------
# LLaMA
# ---------------------------------------------------------------------------

LAYER_KEYS = {
    "input_ln": "input_layernorm.weight",
    "post_ln": "post_attention_layernorm.weight",
    "q": "self_attn.q_proj.weight",
    "k": "self_attn.k_proj.weight",
    "v": "self_attn.v_proj.weight",
    "o": "self_attn.o_proj.weight",
    "gate": "mlp.gate_proj.weight",
    "up": "mlp.up_proj.weight",
    "down": "mlp.down_proj.weight",
}
TRANSPOSED = {"q", "k", "v", "o", "gate", "up", "down"}


def llama_params_from_state_dict(sd: StateDict, cfg: LlamaConfig, prefix: str = "model.",
                                 device=None, dtype: Optional[torch.dtype] = None) -> dict:
    """An HF LLaMA state dict -> the stacked tree of ``weights.init_llava_params``'s
    ``"llm"``."""
    device = resolve_device(device)
    n = cfg.num_hidden_layers
    layers = {
        ours: _stack(sd, [f"{prefix}layers.{i}.{theirs}" for i in range(n)], device, dtype,
                     transpose=ours in TRANSPOSED)
        for ours, theirs in LAYER_KEYS.items()
    }
    params = {
        "embed": _put(sd[f"{prefix}embed_tokens.weight"], device, dtype),
        "layers": layers,
        "final_ln": _put(sd[f"{prefix}norm.weight"], device, dtype),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _put(sd["lm_head.weight"], device, dtype, transpose=True)
    return params


# ---------------------------------------------------------------------------
# CLIP vision tower
# ---------------------------------------------------------------------------


def _ln(sd, name, device, dtype):
    return {"w": _put(sd[f"{name}.weight"], device, dtype),
            "b": _put(sd[f"{name}.bias"], device, dtype)}


def _lin(sd, name, device, dtype):
    p = {"w": _put(sd[f"{name}.weight"], device, dtype, transpose=True)}
    if f"{name}.bias" in sd:
        p["b"] = _put(sd[f"{name}.bias"], device, dtype)
    return p


CLIP_LAYER_KEYS = {
    "ln1": "layer_norm1", "ln2": "layer_norm2",
    "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
    "o": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
}
CLIP_LINEARS = {"q", "k", "v", "o", "fc1", "fc2"}


def clip_params_from_state_dict(sd: StateDict, cfg: ClipVisionConfig,
                                prefix: str = "vision_model.", device=None,
                                dtype: Optional[torch.dtype] = None) -> dict:
    """An HF ``CLIPVisionModel`` state dict -> the tree of ``models.clip``."""
    device = resolve_device(device)
    n = cfg.num_hidden_layers
    lp = f"{prefix}encoder.layers."
    layers = {}
    for ours, theirs in CLIP_LAYER_KEYS.items():
        for part, suffix in (("w", "weight"), ("b", "bias")):
            layers[f"{ours}_{part}"] = _stack(
                sd, [f"{lp}{i}.{theirs}.{suffix}" for i in range(n)], device, dtype,
                transpose=part == "w" and ours in CLIP_LINEARS)
    emb = f"{prefix}embeddings."
    # conv [out, in, kh, kw] -> [kh*kw*in, out] for a single matmul
    conv = sd[f"{emb}patch_embedding.weight"]
    c_out, c_in, kh, kw = conv.shape
    patch = torch.empty((kh * kw * c_in, cfg.hidden_size), device=device,
                        dtype=dtype or conv.dtype)
    patch.view(kh, kw, c_in, c_out).copy_(conv.to(device).permute(2, 3, 1, 0))
    return {
        "class_embedding": _put(sd[f"{emb}class_embedding"], device, dtype),
        "patch_embedding": patch,
        "position_embedding": _put(sd[f"{emb}position_embedding.weight"], device, dtype),
        "pre_ln": _ln(sd, f"{prefix}pre_layrnorm", device, dtype),
        "layers": layers,
        "post_ln": _ln(sd, f"{prefix}post_layernorm", device, dtype),
    }


# ---------------------------------------------------------------------------
# Projector + predictors
# ---------------------------------------------------------------------------


def projector_params_from_state_dict(sd: StateDict, projector_type: str,
                                     prefix: str = "model.mm_projector.", device=None,
                                     dtype: Optional[torch.dtype] = None) -> list:
    """mm_projector: ``linear`` or ``mlpNx_gelu`` (Sequential indices 0, 2,
    4, ...)."""
    device = resolve_device(device)
    if projector_type == "linear":
        return [_lin(sd, prefix[:-1], device, dtype)]
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if not m:
        raise ValueError(f"unsupported projector: {projector_type}")
    return [_lin(sd, f"{prefix}{2 * i}", device, dtype) for i in range(int(m.group(1)))]


def vision_predictor_params_from_state_dict(sd: StateDict, sparse: SparseConfig,
                                            prefix: str = "model.image_score_predictor.",
                                            device=None,
                                            dtype: Optional[torch.dtype] = None) -> dict:
    """The VisionPredictor module tree (``down_mlp.{0: LN, 1: Linear}``,
    ``transformer.{i}.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1,
    mlp.fc2}``, ``output_mlp.{0, 2, 4}``)."""
    device = resolve_device(device)
    p = prefix
    blocks = []
    for i in range(sparse.num_layers):
        bp = f"{p}transformer.{i}"
        blocks.append({
            "norm1": _ln(sd, f"{bp}.norm1", device, dtype),
            "qkv": {"w": _put(sd[f"{bp}.attn.qkv.weight"], device, dtype, transpose=True)},
            "proj": _lin(sd, f"{bp}.attn.proj", device, dtype),
            "norm2": _ln(sd, f"{bp}.norm2", device, dtype),
            "fc1": _lin(sd, f"{bp}.mlp.fc1", device, dtype),
            "fc2": _lin(sd, f"{bp}.mlp.fc2", device, dtype),
        })
    return {
        "down_norm": _ln(sd, f"{p}down_mlp.0", device, dtype),
        "down": _lin(sd, f"{p}down_mlp.1", device, dtype),
        "blocks": blocks,
        "out1": _lin(sd, f"{p}output_mlp.0", device, dtype),
        "out2": _lin(sd, f"{p}output_mlp.2", device, dtype),
        "out3": _lin(sd, f"{p}output_mlp.4", device, dtype),
    }


def text_predictor_params_from_state_dict(sd: StateDict, prefix: str, device=None,
                                          dtype: Optional[torch.dtype] = None) -> dict:
    """The TextPredictor ``output_mlp.{0: LN, 1, 3, 5, 7: Linear}``."""
    device = resolve_device(device)
    return {
        "norm": _ln(sd, f"{prefix}output_mlp.0", device, dtype),
        "fc1": _lin(sd, f"{prefix}output_mlp.1", device, dtype),
        "fc2": _lin(sd, f"{prefix}output_mlp.3", device, dtype),
        "fc3": _lin(sd, f"{prefix}output_mlp.5", device, dtype),
        "fc4": _lin(sd, f"{prefix}output_mlp.7", device, dtype),
    }


# ---------------------------------------------------------------------------
# Checkpoint files (safetensors / torch bins)
# ---------------------------------------------------------------------------


def _load_safetensors(path: str) -> StateDict:
    try:
        from safetensors import safe_open
    except ImportError as e:
        raise ImportError(
            f"{path} is a safetensors file and the safetensors package is not "
            "installed") from e
    with safe_open(path, framework="pt", device="cpu") as fh:
        return {k: fh.get_tensor(k) for k in fh.keys()}


def load_state_dict_file(path: str) -> StateDict:
    """One weights file (``.safetensors`` or a torch ``.bin`` / ``.pt``) as
    CPU tensors in the file's dtype; a torch file is memory-mapped, so its
    tensors take no anonymous memory until they are copied."""
    if path.endswith(".safetensors"):
        return _load_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def weight_files(model_dir: str) -> List[str]:
    """The weight files of an HF model directory: the safetensors files if
    there are any, else the torch ``.bin`` files; where a shard index
    (``*.index.json``) is present, the shards its ``weight_map`` names."""
    names = os.listdir(model_dir)
    for suffix in (".safetensors", ".bin"):
        files = sorted(f for f in names if f.endswith(suffix))
        if not files:
            continue
        index = [f for f in names if f.endswith(f"{suffix}.index.json")]
        if index:
            with open(os.path.join(model_dir, index[0])) as fh:
                files = sorted(set(json.load(fh)["weight_map"].values()))
        return [os.path.join(model_dir, f) for f in files]
    raise FileNotFoundError(f"no weights found in {model_dir}")


def load_state_dict_from_dir(model_dir: str) -> StateDict:
    """Every weight of an HF model directory (``weight_files``), as CPU
    tensors in the files' dtypes."""
    sd: StateDict = {}
    for path in weight_files(model_dir):
        sd.update(load_state_dict_file(path))
    return sd
