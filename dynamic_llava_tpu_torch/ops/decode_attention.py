"""Decode attention: kernel K2 and its plain PyTorch version.

Counterpart of ``dynamic_llava_tpu/ops/decode_attention.py``
(``flash_decode_attention`` over the Pallas ``_decode_kernel``), ported to
the contract the decode layer loop calls, ``decode_attend_appended``: the
current token's K/V are appended virtually to the persisted cache rows
``[0, length)``, the cache stored in bf16, fp32, fp8 or scaled int8, with
an optional sliding window. On a CUDA tensor ``decode_attention`` launches the
hand-written Hopper kernel ``csrc/decode_attention.cu``, which reads only
the live rows and splits them over ``decode_split`` blocks per (kv head,
sample), merged inside the same launch; on a CPU tensor it runs the plain
version (``ops.attention.decode_attend_appended``). There is no fallback
from one to the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .attention import decode_attend_appended as decode_attention_plain

__all__ = ["decode_attention", "decode_attention_plain", "decode_split"]


# storage codes of the cache (csrc/common.cuh DType): q's own codes plus the
# one-byte modes
STORAGE_CODES = {**kernels.DTYPE_CODES, torch.int8: 2, torch.float8_e4m3fn: 3}


# the split of the cache length over blocks (flash-decoding)
SPLIT_TARGET_BLOCKS = 128  # about a block an SM: more splits bought nothing on the H100
SPLIT_MIN_ROWS = 64  # cache rows a block owns at least
MAX_SPLIT = 32  # kMaxSplit of csrc/decode_attention.cu


def decode_split(b: int, hkv: int, max_len: int) -> int:
    """Blocks that share the cache rows of one (kv head, sample): enough for
    ``SPLIT_TARGET_BLOCKS`` blocks a call, each owning at least
    ``SPLIT_MIN_ROWS`` rows of the capacity. A function of the shapes alone
    (the lengths live on the device), so every call with the same shapes
    sums in the same order."""
    want = -(-SPLIT_TARGET_BLOCKS // max(1, b * hkv))
    return max(1, min(want, max_len // SPLIT_MIN_ROWS, MAX_SPLIT))


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, d]
    k_cache: torch.Tensor,  # [B, max_len, Hkv, d]
    v_cache: torch.Tensor,  # [B, max_len, Hkv, d]
    k_cur: torch.Tensor,  # [B, 1, Hkv, d]
    v_cur: torch.Tensor,  # [B, 1, Hkv, d]
    length: torch.Tensor,  # [B] int32 attend bound (the persisted length)
    *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    q_pos: Optional[torch.Tensor] = None,  # [B] int32, with ``window``
    k_scale: Optional[torch.Tensor] = None,  # [B, max_len, Hkv] bf16, int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token attention over ``cache[:length] ++ current``; returns
    ``[B, 1, H, d]`` in q's dtype. The cache is stored in bf16, fp32, fp8
    (``float8_e4m3fn``) or int8 with per-vector ``k_scale`` / ``v_scale``
    (folded into scores and probabilities, never dequantized); ``length``
    is the attend bound (the ring policy passes ``min(length, budget)``);
    with ``window`` only columns ``j`` with ``q_pos - j < window`` are
    visible (and read)."""
    store = k_cache.dtype
    if (store == torch.int8) != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention: k_scale and v_scale go with an int8 "
                         "cache, both or neither")
    if window is not None and (q_pos is None or window < 1):
        raise ValueError(f"decode_attention: window {window} must be >= 1 and come "
                         "with q_pos")
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, k_cur, v_cur, length, scale=scale,
            window=window, q_pos=q_pos, k_scale=k_scale, v_scale=v_scale,
        )
    if not q.is_cuda:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, one, h, d = q.shape
    _, max_len, hkv, _ = k_cache.shape
    if q.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"decode_attention: unsupported dtype {q.dtype}")
    if one != 1 or d not in (64, 128) or hkv == 0 or h % hkv or h // hkv > 8:
        raise ValueError(
            f"decode_attention: need q [B, 1, H, d] with d in (64, 128) and "
            f"H a multiple of Hkv with H/Hkv <= 8, got q {tuple(q.shape)} "
            f"cache {tuple(k_cache.shape)}"
        )
    if store not in STORAGE_CODES:
        raise ValueError(f"decode_attention: unsupported cache dtype {store}")

    def need(name, t, dtype, shape):
        # 16-byte alignment holds for every layer view of a stacked buffer
        # (a layer is a multiple of 64 bytes), and is checked all the same
        if (t is None or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != q.device
                or t.data_ptr() % 16):
            raise ValueError(
                f"decode_attention: {name} must be a contiguous, 16-byte "
                f"aligned {dtype} tensor of shape {shape} on {q.device}, got "
                f"{None if t is None else (tuple(t.shape), t.dtype, t.device)}"
            )

    need("q", q, q.dtype, (b, 1, h, d))
    need("k_cache", k_cache, store, (b, max_len, hkv, d))
    need("v_cache", v_cache, store, (b, max_len, hkv, d))
    need("k_cur", k_cur, q.dtype, (b, 1, hkv, d))
    need("v_cur", v_cur, q.dtype, (b, 1, hkv, d))
    if k_scale is not None:
        need("k_scale", k_scale, torch.bfloat16, (b, max_len, hkv))
        need("v_scale", v_scale, torch.bfloat16, (b, max_len, hkv))
    for name, t in (("length", length),) + ((("q_pos", q_pos),) if window is not None else ()):
        if (t is None or t.dtype != torch.int32 or tuple(t.shape) != (b,)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"decode_attention: {name} must be a contiguous [B] "
                             "int32 tensor on q's device")
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    lib = kernels.load_library().lib
    n_split = decode_split(b, hkv, max_len)
    workspace = tickets = None  # None: a null pointer
    nbytes = lib.decode_attention_workspace_bytes(b, h, hkv, d, n_split)
    if n_split > 1:
        # from the caching allocator on every call: safe on any stream and
        # under CUDA-graph capture
        workspace = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
        tickets = kernels.tickets(q, b * hkv)
    code = lib.decode_attention_appended(
        kernels.ptr(q), kernels.ptr(k_cache), kernels.ptr(v_cache),
        kernels.ptr(k_cur), kernels.ptr(v_cur), kernels.ptr(length),
        None if k_scale is None else kernels.ptr(k_scale),  # None: a null pointer
        None if v_scale is None else kernels.ptr(v_scale),
        None if window is None else kernels.ptr(q_pos),
        kernels.ptr(out),
        None if workspace is None else kernels.ptr(workspace), nbytes,
        None if tickets is None else kernels.ptr(tickets), n_split,
        b, max_len, h, hkv, d, float(scale),
        0 if window is None else int(window),
        kernels.DTYPE_CODES[q.dtype], STORAGE_CODES[store], kernels.stream_of(q),
    )
    kernels.check(code, "decode_attention_appended")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
