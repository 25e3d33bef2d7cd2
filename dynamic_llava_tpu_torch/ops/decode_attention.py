"""Decode attention: kernel K2 and its plain PyTorch version.

Counterpart of ``dynamic_llava_tpu/ops/decode_attention.py``
(``flash_decode_attention`` over the Pallas ``_decode_kernel``), ported to
the contract the decode layer loop calls, ``decode_attend_appended``: the
current token's K/V are appended virtually to the persisted cache rows
``[0, length)``. On a CUDA tensor ``decode_attention`` launches the
hand-written Hopper kernel ``csrc/decode_attention.cu``, which reads only
the live rows; on a CPU tensor it runs the plain version
(``ops.attention.decode_attend_appended``). There is no fallback from one
to the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .attention import decode_attend_appended as decode_attention_plain

__all__ = ["decode_attention", "decode_attention_plain"]


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, d]
    k_cache: torch.Tensor,  # [B, max_len, Hkv, d]
    v_cache: torch.Tensor,  # [B, max_len, Hkv, d]
    k_cur: torch.Tensor,  # [B, 1, Hkv, d]
    v_cur: torch.Tensor,  # [B, 1, Hkv, d]
    length: torch.Tensor,  # [B] int32 persisted length
    *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token attention over ``cache[:length] ++ current``; returns
    ``[B, 1, H, d]`` in q's dtype. The sliding window and the int8-KV scales
    of the JAX contract are not in this kernel yet: asking for them
    raises."""
    if window is not None or k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "decode_attention: sliding window and int8 K/V scales are not "
            "supported yet"
        )
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, k_cur, v_cur, length, scale=scale
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
    for name, t, shape in (
        ("q", q, (b, 1, h, d)),
        ("k_cache", k_cache, (b, max_len, hkv, d)),
        ("v_cache", v_cache, (b, max_len, hkv, d)),
        ("k_cur", k_cur, (b, 1, hkv, d)),
        ("v_cur", v_cur, (b, 1, hkv, d)),
    ):
        if (t.dtype != q.dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != q.device
                or t.data_ptr() % 16):
            raise ValueError(
                f"decode_attention: {name} must be a contiguous, 16-byte "
                f"aligned {q.dtype} tensor of shape {shape} on {q.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if (length.dtype != torch.int32 or tuple(length.shape) != (b,)
            or not length.is_contiguous() or length.device != q.device):
        raise ValueError("decode_attention: length must be a contiguous [B] "
                         "int32 tensor on q's device")
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    lib = kernels.load_library().lib
    code = lib.decode_attention_appended(
        kernels.ptr(q), kernels.ptr(k_cache), kernels.ptr(v_cache),
        kernels.ptr(k_cur), kernels.ptr(v_cur), kernels.ptr(length),
        kernels.ptr(out), b, max_len, h, hkv, d, float(scale),
        kernels.DTYPE_CODES[q.dtype], kernels.stream_of(q),
    )
    kernels.check(code, "decode_attention_appended")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
