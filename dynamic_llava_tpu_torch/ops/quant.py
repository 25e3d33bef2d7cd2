"""Weight-only int8 / int4 quantization for serving (counterpart of
``dynamic_llava_tpu/ops/quant.py``).

A quantized weight is a dict leaf: ``{"q": int8 [..., in, out], "s": [..., 1, out]}``
or, for int4, ``{"q4": int8 [..., in, out/2], "s": ...}`` with two nibbles
per byte in the split-half layout of ``pack_int4``. Scales are per output
channel (per row for the embedding) and keep the source weight's dtype.

``linear`` / ``linear_group`` are the dispatch of the JAX ``matmul_q8``,
``matmul_q4``, ``matmul_q8_group``, ``matmul_q4_group`` and
``train.lora.lora_proj`` (without LoRA): up to ``MAX_ROWS`` rows go to the
GEMVs K5-K8 (``ops.quant_matmul``: the CUDA kernels on a CUDA tensor, their
plain versions on a CPU tensor); larger (prefill) row counts dequantize the
layer's weight and run one ``torch.matmul``, as the JAX package leaves that
product to an XLA einsum. A plain tensor weight is ``x @ w``.
``matmul_q4_mlp`` is the JAX dispatch of the same name: the whole SwiGLU
MLP as ONE kernel (K9) when gate, up and down are all int4, at decode rows,
opt-in through ``DYNAMIC_LLAVA_Q4_MLP=1``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

from ..weights import resolve_device
from .quant_matmul import (
    MAX_ROWS, q4_gemv, q4_gemv_group, q4_mlp, q8_gemv, q8_gemv_group, unpack_int4)

__all__ = [
    "QUANT_TARGETS", "pack_int4", "unpack_int4", "quantize_weight",
    "quantize_llm_params", "init_quantized_llama_params", "dequantize_weight",
    "is_quantized", "linear", "linear_group", "matmul", "matmul_q4_mlp", "q4_mlp_enabled",
]

QUANT_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4-valued int8 numbers into nibble pairs along the LAST axis,
    split-half: byte k holds element k in its low nibble and element
    n/2 + k in its high nibble (n = last-dim size)."""
    if q.shape[-1] % 2:
        raise ValueError(f"last dim must be even, got {tuple(q.shape)}")
    half = q.shape[-1] // 2
    q = q.to(torch.int32)
    byte = (q[..., :half] & 0x0F) | ((q[..., half:] & 0x0F) << 4)
    return byte.to(torch.uint8).view(torch.int8)


def _quantize_2d(w: torch.Tensor, axis: int, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, scale in w's dtype). The rounding is the JAX one: the
    fp32 scale ``max(amax / qmax, 1e-8)`` divides, ``torch.round`` rounds
    half to even like ``jnp.round``, and only then is the scale stored in
    the weight's dtype."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    qmax = 127.0 if bits == 8 else 7.0
    # XLA compiles ``amax / qmax`` (a constant divisor) as a product with
    # the fp32 reciprocal; doing the same keeps the scales bit-identical
    inv = torch.tensor(1.0 / qmax, dtype=torch.float32, device=w.device)
    scale = torch.clamp(amax * inv, min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    return q, scale.to(w.dtype)


def quantize_weight(w: torch.Tensor, axis: int = 0, bits: int = 8) -> dict:
    """Symmetric per-channel int8 (``bits=8``) or packed int4 (``bits=4``),
    the amax taken over ``axis``. A 3-D layer stack is quantized one layer
    at a time (``axis`` counts the stack axis), so no fp32 copy of a whole
    stack exists."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    key = "q4" if bits == 4 else "q"

    def one(wl, ax):
        q, s = _quantize_2d(wl, ax, bits)
        return (pack_int4(q) if bits == 4 else q), s

    if w.dim() != 3:
        q, s = one(w, axis)
        return {key: q, "s": s}
    q0, s0 = one(w[0], axis - 1)
    qs = q0.new_empty((w.shape[0], *q0.shape))
    ss = s0.new_empty((w.shape[0], *s0.shape))
    qs[0], ss[0] = q0, s0
    for i in range(1, w.shape[0]):
        qs[i], ss[i] = one(w[i], axis - 1)
    return {key: qs, "s": ss}


def dequantize_weight(leaf, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if isinstance(leaf, dict) and "q4" in leaf:
        return unpack_int4(leaf["q4"]).to(dtype) * leaf["s"].to(dtype)
    if isinstance(leaf, dict) and "q" in leaf:
        return leaf["q"].to(dtype) * leaf["s"].to(dtype)
    return leaf


def is_quantized(leaf) -> bool:
    """A quantized leaf has ``"s"`` and ``"q"`` or ``"q4"`` (the layers dict
    has a key ``"q"`` of its own, the q projection, and no ``"s"``)."""
    return isinstance(leaf, dict) and "s" in leaf and ("q" in leaf or "q4" in leaf)


def quantize_llm_params(params: dict, bits: int = 8) -> dict:
    """Quantize the decoder's ``QUANT_TARGETS``, embedding and untied
    lm_head IN PLACE; norms, the vision tower, projector and predictors
    stay as they are. Each full-precision weight is released as soon as its
    quantized form exists (at 7B the two sets together would double the
    weights' memory). Layer stacks ``[L, in, out]`` get per (layer, output
    channel) scales; the embedding per row (``[V, 1]``), the untied lm_head
    per output column."""
    llm = params["llm"]
    layers = llm["layers"]
    for name in QUANT_TARGETS:
        layers[name] = quantize_weight(layers.pop(name), axis=1, bits=bits)
    llm["embed"] = quantize_weight(llm.pop("embed"), axis=1, bits=bits)
    if "lm_head" in llm:
        llm["lm_head"] = quantize_weight(llm.pop("lm_head"), axis=0, bits=bits)
    return params


def init_quantized_llama_params(cfg, generator: torch.Generator, device=None,
                                bits: int = 8) -> dict:
    """A random decoder made DIRECTLY in int8 or packed int4 on ``device``
    (default: the card, ``weights.resolve_device``; ``generator`` must live
    there), for models whose full-precision
    weights need not exist: every ``QUANT_TARGETS`` weight, the embedding
    and the untied lm_head hold uniform integers in [-qmax, qmax] with a
    bf16 scale that gives the dequantized weights a std of 0.02, as
    ``quantize_llm_params`` gives normal(0, 0.02) weights. int4 draws the
    two nibble halves separately at packed size. Norms are bf16 ones.
    Unlike the JAX version (whose embed scale is ``[1, D]``, so that
    ``embed_tokens`` gathers out of bounds for every id >= 1), the embed
    scale is per row, ``[V, 1]``, as ``quantize_llm_params`` makes it."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    device = resolve_device(device)
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    h, kvh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qmax = 127 if bits == 8 else 7
    levels = 2 * qmax + 1
    scale = 0.02 / ((levels * levels - 1) / 12.0) ** 0.5  # std of the uniform grid
    bf16 = torch.bfloat16

    def ints(*shape):
        return torch.randint(-qmax, qmax + 1, shape, generator=generator,
                             device=device, dtype=torch.int8)

    def quant(shape, axis):
        s_shape = list(shape)
        s_shape[axis] = 1
        s = torch.full(s_shape, scale, dtype=bf16, device=device)
        if bits == 8:
            return {"q": ints(*shape), "s": s}
        packed = (*shape[:-1], shape[-1] // 2)
        lo, hi = ints(*packed), ints(*packed)
        # hi * 16 stays in [-112, 112]: no int8 overflow
        return {"q4": (lo & 0x0F) | (hi << 4), "s": s}

    shapes = {"q": (n, d, h * hd), "k": (n, d, kvh * hd), "v": (n, d, kvh * hd),
              "o": (n, h * hd, d), "gate": (n, d, f), "up": (n, d, f),
              "down": (n, f, d)}
    layers = {name: quant(shape, 1) for name, shape in shapes.items()}
    layers["input_ln"] = torch.ones(n, d, dtype=bf16, device=device)
    layers["post_ln"] = torch.ones(n, d, dtype=bf16, device=device)
    params = {
        "embed": quant((cfg.vocab_size, d), 1),
        "layers": layers,
        "final_ln": torch.ones(d, dtype=bf16, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = quant((d, cfg.vocab_size), 0)
    return params


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1]


class _MmFp32Out(torch.autograd.Function):
    """``x @ w`` of low-precision CUDA operands with an fp32 result (the JAX
    ``preferred_element_type=float32``), which ``torch.mm(out_dtype=)``
    computes but does not differentiate. The backward rounds the incoming
    gradient to the operands' dtype and runs the two transposed products."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w.T if ctx.needs_input_grad[0] else None
        dw = x.T @ g if ctx.needs_input_grad[1] else None
        return dx, dw


def matmul(x: torch.Tensor, w, out_fp32: bool = False) -> torch.Tensor:
    """``x @ w`` for a plain or quantized weight ``[K, N]``; fp32 output
    with ``out_fp32`` (accumulation is fp32 either way)."""
    if not is_quantized(w):
        if out_fp32 and x.is_cuda and x.dtype != torch.float32:
            y = _MmFp32Out.apply(x.reshape(-1, x.shape[-1]), w)
            return y.reshape(*x.shape[:-1], w.shape[-1])
        return x.float() @ w.float() if out_fp32 else x @ w
    if _rows(x) <= MAX_ROWS:
        x = x.contiguous()
        if "q4" in w:
            return q4_gemv(x, w["q4"], w["s"], out_fp32)
        return q8_gemv(x, w["q"], w["s"], out_fp32)
    return matmul(x, dequantize_weight(w, x.dtype), out_fp32)


def linear(lp: dict, name: str, x: torch.Tensor, out_fp32: bool = False) -> torch.Tensor:
    """``x @ lp[name]`` (the JAX ``lora_proj`` without an adapter)."""
    return matmul(x, lp[name], out_fp32)


def linear_group(lp: dict, names: Sequence[str], x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``linear`` for several weights sharing ``x`` (q/k/v, gate/up): ONE
    grouped GEMV launch (K6 / K8) when they are all int8 or all int4 and
    ``x`` has decode rows; otherwise one ``linear`` each."""
    leaves = [lp[n] for n in names]
    if _rows(x) <= MAX_ROWS and all(is_quantized(w) for w in leaves):
        x = x.contiguous()
        if all("q" in w for w in leaves):
            return q8_gemv_group(x, [w["q"] for w in leaves], [w["s"] for w in leaves])
        if all("q4" in w for w in leaves):
            return q4_gemv_group(x, [w["q4"] for w in leaves], [w["s"] for w in leaves])
    return tuple(matmul(x, w) for w in leaves)


def q4_mlp_enabled() -> bool:
    """Whether ``DYNAMIC_LLAVA_Q4_MLP`` switches the fused int4 MLP on, as
    read at this moment (``matmul_q4_mlp`` reads it at every dispatch)."""
    return os.environ.get("DYNAMIC_LLAVA_Q4_MLP") in ("1", "true", "True")


def matmul_q4_mlp(x: torch.Tensor, lp: dict, out_fp32: bool = False
                  ) -> Optional[torch.Tensor]:
    """The whole SwiGLU MLP, ``silu(x @ gate) * (x @ up) @ down``, as ONE
    kernel launch (K9, ``quant_matmul.q4_mlp``) when all three leaves are
    packed int4. Returns the MLP output, or None when not eligible (a leaf
    that is not int4, prefill row counts, inconsistent shapes) or not
    switched on; the caller then takes the grouped gate/up GEMV (K8) and
    the down GEMV (K7).

    OPT-IN, as in the JAX package: only with ``DYNAMIC_LLAVA_Q4_MLP`` set to
    ``1`` / ``true`` in the environment, read at every dispatch so that one
    process can run both settings in turn. The fused path forms ``h`` from
    the fp32 gate and up sums, the two-kernel path from their bf16-rounded
    outputs, so the two agree to bf16 rounding, not bit for bit. (The JAX
    dispatch also refuses LoRA-adapted leaves; the port has no LoRA yet, so
    there is nothing to exclude -- the port of ``train/lora.py`` must add
    that rule here.)"""
    leaves = [lp.get(n) for n in ("gate", "up", "down")]
    if not all(is_quantized(l) and "q4" in l for l in leaves):
        return None
    if not q4_mlp_enabled():
        return None
    g, u, d = leaves
    if _rows(x) > MAX_ROWS:
        return None
    k_dim, half_f = g["q4"].shape[-2:]
    f_dim = d["q4"].shape[-2]
    if (g["q4"].dim() != 2 or d["q4"].dim() != 2 or x.shape[-1] != k_dim
            or tuple(u["q4"].shape) != (k_dim, half_f) or f_dim != 2 * half_f):
        return None
    return q4_mlp(x.contiguous(), g["q4"], u["q4"], d["q4"], g["s"], u["s"], d["s"],
                  out_fp32)
