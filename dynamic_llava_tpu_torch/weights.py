"""Parameters: the bridge from the JAX package's params, and a torch-side
random init with the same structure.

The port's param tree is the JAX pytree with torch tensors in place of
arrays: ``{"llm", "vision_tower", "mm_projector", "predictors"}``, layer
weights stacked ``[L, ...]``, linears ``[in, out]``
(``dynamic_llava_tpu/models/llama.py:init_llama_params``,
``clip.py:init_clip_params``, ``projector.py:init_projector_params``,
``predictors.py:init_predictors``). Both ``init_llava_params`` of the JAX
package and its HF converter (``models/convert.py``) produce that tree, so
one bridge serves random and converted weights.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .config import LlavaConfig


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another (``"cpu"``, as the tests do). ``None`` means ``"cuda"``; a
    machine without a card then raises here instead of serving on the CPU
    through the plain versions without a word."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for (the default) and "
            "torch.cuda.is_available() is False; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def params_from_numpy(tree: Any, device=None, dtype: torch.dtype = torch.bfloat16):
    """Convert a pytree of arrays (numpy, or anything ``np.asarray``
    accepts) to torch tensors on ``device`` (default: the card, see
    ``resolve_device``): floating leaves in ``dtype``, integer leaves
    unchanged. Dicts and lists keep their structure."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    arr = np.asarray(tree)
    # floating includes ml_dtypes' bfloat16 (JAX bf16 leaves), which
    # np.floating does not cover and torch.from_numpy refuses
    if not (np.issubdtype(arr.dtype, np.integer) or arr.dtype == np.bool_):
        return torch.from_numpy(np.array(arr, np.float32)).to(
            device=device, dtype=dtype
        )
    return torch.from_numpy(np.array(arr)).to(device)


def params_to_numpy(tree: Any):
    """The inverse of ``params_from_numpy``: the same structure with numpy
    arrays (floating leaves as float32, integer leaves unchanged)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf, dict keys sorted and list items in
    order (the order of ``jax.tree.leaves``). A path joins the keys with
    ``/``; a list index appears as ``[i]``, as in the JAX key paths the
    optimizer's labels are matched on."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}[{i}]/")
    else:
        yield prefix[:-1], tree


def map_leaves(fn, tree: Any, prefix: str = ""):
    """The tree with ``fn(path, leaf)`` in place of every leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, f"{prefix}[{i}]/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


STACKED_PREFIXES = ("llm/layers/", "vision_tower/layers/")


def trainable_view(params: Any, grads: Dict[str, torch.Tensor]):
    """The param tree for one differentiated forward: every leaf whose path
    is in ``grads`` becomes an autograd leaf (``requires_grad``) that shares
    the parameter's storage and whose ``.grad`` IS the buffer
    ``grads[path]``, so ``backward()`` accumulates in place into the
    buffers the optimizer holds; every other leaf stays a plain tensor and
    gets no gradient at all. A stacked ``[L, ...]`` layer leaf becomes a
    list of L per-layer leaves whose ``.grad`` are the slices
    ``grads[path][i]``: indexing the stacked tensor under autograd would
    instead build a full-size zero tensor for every layer's gradient."""

    def leaf_of(t: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        leaf = t.detach().requires_grad_(True)
        leaf.grad = g
        return leaf

    def view(path: str, t: torch.Tensor):
        g: Optional[torch.Tensor] = grads.get(path)
        if g is None:
            return t
        if path.startswith(STACKED_PREFIXES):
            return [leaf_of(t[i], g[i]) for i in range(t.shape[0])]
        return leaf_of(t, g)

    return map_leaves(view, params)


class _Init:
    """normal(0, 0.02) sampled directly in the target dtype and on the
    target device (a 7B bf16 model is never built in fp32 or on the host);
    ones for norm weights, zeros for biases."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, device, dtype

    def normal(self, *shape):
        t = torch.empty(shape, device=self.device, dtype=self.dtype)
        return t.normal_(0.0, 0.02, generator=self.g)

    def ones(self, *shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def zeros(self, *shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def linear(self, d_in, d_out, bias=True):
        p = {"w": self.normal(d_in, d_out)}
        if bias:
            p["b"] = self.zeros(d_out)
        return p

    def ln(self, d):
        return {"w": self.ones(d), "b": self.zeros(d)}


def _init_llama(it: _Init, cfg) -> dict:
    d, f = cfg.hidden_size, cfg.intermediate_size
    h, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    n = cfg.num_hidden_layers
    params = {
        "embed": it.normal(cfg.vocab_size, d),
        "layers": {
            "input_ln": it.ones(n, d),
            "post_ln": it.ones(n, d),
            "q": it.normal(n, d, h * hd),
            "k": it.normal(n, d, kvh * hd),
            "v": it.normal(n, d, kvh * hd),
            "o": it.normal(n, h * hd, d),
            "gate": it.normal(n, d, f),
            "up": it.normal(n, d, f),
            "down": it.normal(n, f, d),
        },
        "final_ln": it.ones(d),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = it.normal(d, cfg.vocab_size)
    return params


def _init_clip(it: _Init, cfg) -> dict:
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    layers = {}
    for ln in ("ln1", "ln2"):
        layers[f"{ln}_w"], layers[f"{ln}_b"] = it.ones(n, d), it.zeros(n, d)
    for name, (d_in, d_out) in {
        "q": (d, d), "k": (d, d), "v": (d, d), "o": (d, d),
        "fc1": (d, f), "fc2": (f, d),
    }.items():
        layers[f"{name}_w"] = it.normal(n, d_in, d_out)
        layers[f"{name}_b"] = it.zeros(n, d_out)
    return {
        "class_embedding": it.normal(d),
        "patch_embedding": it.normal(cfg.patch_size * cfg.patch_size * 3, d),
        "position_embedding": it.normal(cfg.num_positions, d),
        "pre_ln": it.ln(d),
        "layers": layers,
        "post_ln": it.ln(d),
    }


def _projector_depth(projector_type: str) -> int:
    """Number of linears (``parse_projector_type`` of the JAX package)."""
    if projector_type == "identity":
        return 0
    if projector_type == "linear":
        return 1
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if not m:
        raise ValueError(f"Unknown projector type: {projector_type}")
    return int(m.group(1))


def _init_text_predictor(it: _Init, d_in: int, d: int) -> dict:
    return {
        "norm": it.ln(d_in),
        "fc1": it.linear(d_in, d),
        "fc2": it.linear(d, d // 2),
        "fc3": it.linear(d // 2, d // 4),
        "fc4": it.linear(d // 4, 2),
    }


def _init_predictors(it: _Init, cfg: LlavaConfig) -> dict:
    sp, d_in, d = cfg.sparse, cfg.text.hidden_size, cfg.sparse.d_model
    preds = {}
    if sp.use_vision_predictor:
        preds["image_score_predictor"] = {
            "down_norm": it.ln(d_in),
            "down": it.linear(d_in, d),
            "blocks": [
                {
                    "norm1": it.ln(d),
                    "qkv": it.linear(d, 3 * d, bias=False),
                    "proj": it.linear(d, d),
                    "norm2": it.ln(d),
                    "fc1": it.linear(d, sp.dim_feedforward),
                    "fc2": it.linear(sp.dim_feedforward, d),
                }
                for _ in range(sp.num_layers)
            ],
            "out1": it.linear(d, d // 2),
            "out2": it.linear(d // 2, d // 4),
            "out3": it.linear(d // 4, 2),
        }
    if sp.use_output_text_predictor:
        preds["output_text_score_predictor"] = _init_text_predictor(it, d_in, d)
    if sp.use_instruct_predictor:
        preds["instruct_score_predictor"] = _init_text_predictor(it, d_in, d)
    return preds


def init_llava_params(
    cfg: LlavaConfig,
    generator: torch.Generator,
    device=None,
    dtype: torch.dtype = torch.bfloat16,
) -> dict:
    """Random params with the structure of the JAX ``init_llava_params``,
    drawn from ``generator`` (which must live on ``device``; default: the
    card, see ``resolve_device``). The values
    differ from the JAX ones for the same seed; tests that compare the two
    packages bridge the JAX params instead."""
    it = _Init(generator, resolve_device(device), dtype)
    dims = [cfg.vision.hidden_size] + [cfg.text.hidden_size] * _projector_depth(
        cfg.mm_projector_type
    )
    params = {
        "llm": _init_llama(it, cfg.text),
        "vision_tower": _init_clip(it, cfg.vision),
        "mm_projector": [it.linear(dims[i], dims[i + 1]) for i in range(len(dims) - 1)],
    }
    preds = _init_predictors(it, cfg)
    if preds:
        params["predictors"] = preds
    return params


def param_bytes(tree: Any) -> int:
    """Total bytes of the tensors in a param tree."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()

