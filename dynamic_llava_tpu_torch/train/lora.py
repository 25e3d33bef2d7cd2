"""LoRA adapters for the stacked decoder (counterpart of
``dynamic_llava_tpu/train/lora.py``).

Adapters are extra leaves next to each target weight in the layers dict:
``layers["q_lora"] = {"a": [L, in, r], "b": [L, r, out], "s": 0-d}``, and
every linear of the decoder (``ops.quant.linear`` / ``linear_group``) adds
``((x @ a) @ b) * s`` to its base product, whatever route that product
takes (cuBLAS, the int8 / int4 GEMVs, or the dequantized weight). The
base weight stays frozen (``train.optimizer.label_params(lora_mode=True)``),
so QLoRA is a quantized base (``ops.quant.quantize_llm_params``, called
BEFORE the adapters are attached) plus float adapters.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..config import LlamaConfig
from ..ops.quant import is_quantized, linear
from ..weights import resolve_device

DEFAULT_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


def init_lora_params(
    cfg: LlamaConfig,
    generator: torch.Generator,
    rank: int = 128,
    alpha: float = 256.0,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Dict[str, dict]:
    """A ~ N(0, 1/r), B = 0 (the adapter starts as a no-op), drawn from
    ``generator`` on ``device`` (default: the card, ``weights.resolve_device``;
    the generator must live there). The ``alpha / rank`` scale is a 0-d
    leaf in ``dtype`` that never trains."""
    device = resolve_device(device)
    d, f = cfg.hidden_size, cfg.intermediate_size
    nq = cfg.num_attention_heads * cfg.head_dim
    nkv = cfg.num_key_value_heads * cfg.head_dim
    dims = {"q": (d, nq), "k": (d, nkv), "v": (d, nkv), "o": (nq, d),
            "gate": (d, f), "up": (d, f), "down": (f, d)}
    n = cfg.num_hidden_layers
    out = {}
    for t in targets:
        d_in, d_out = dims[t]
        a = torch.randn((n, d_in, rank), generator=generator, dtype=dtype, device=device)
        out[f"{t}_lora"] = {
            "a": a.mul_(rank**-0.5),
            "b": torch.zeros((n, rank, d_out), dtype=dtype, device=device),
            "s": torch.tensor(alpha / rank, dtype=dtype, device=device),
        }
    return out


def attach_lora(params: dict, lora_layers: Dict[str, dict]) -> dict:
    """``params`` with the adapters added to the layers dict (new dicts
    along the path; every tensor is shared)."""
    layers = dict(params["llm"]["layers"])
    layers.update(lora_layers)
    return dict(params, llm=dict(params["llm"], layers=layers))


def lora_proj(lp: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """``x @ W`` plus ``s * (x @ A) @ B`` when an adapter is attached; W
    may be quantized (``ops.quant.linear``)."""
    return linear(lp, name, x)


def split_lora_state(params: dict):
    """``(adapters, other trainables)``: the split checkpointing of
    ``adapter_model`` against ``non_lora_trainables`` (predictors and
    projector)."""
    lora = {k: v for k, v in params["llm"]["layers"].items() if k.endswith("_lora")}
    non_lora = {k: params[k] for k in ("predictors", "mm_projector") if k in params}
    return lora, non_lora


def strip_lora(params: dict) -> dict:
    """``params`` without its adapters (new dicts along the path)."""
    layers = {k: v for k, v in params["llm"]["layers"].items() if not k.endswith("_lora")}
    return dict(params, llm=dict(params["llm"], layers=layers))


@torch.no_grad()
def merge_lora_pytree(params: dict, alpha: float = 1.0, rank: int = 1) -> dict:
    """Fold each adapter into its base weight and drop it (the inference
    merge): ``W + (A @ B) * s`` formed in fp32 and rounded once to W's
    dtype, one layer at a time. An adapter without ``s`` uses
    ``alpha / rank``. A quantized base cannot take the fold and raises."""
    layers = dict(params["llm"]["layers"])
    for name in [k for k in layers if k.endswith("_lora")]:
        base_name = name[: -len("_lora")]
        ad, base = layers.pop(name), layers[base_name]
        if is_quantized(base):
            raise ValueError(f"merge_lora_pytree: {base_name} is quantized")
        s = ad["s"].float() if "s" in ad else torch.tensor(alpha / rank)
        merged = torch.empty_like(base)
        for i in range(base.shape[0]):
            ab = ad["a"][i].float() @ ad["b"][i].float()
            merged[i] = base[i].float() + ab * s.to(ab.device)
        layers[base_name] = merged
    return dict(params, llm=dict(params["llm"], layers=layers))
