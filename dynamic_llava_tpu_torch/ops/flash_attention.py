"""Fused prefill attention: kernel K1 and its plain PyTorch version.

Counterpart of ``dynamic_llava_tpu/ops/flash_attention.py``
(``flash_attention`` over the Pallas ``_flash_kernel``). On a CUDA tensor
``flash_attention`` launches the hand-written Hopper kernel
``csrc/flash_attention_fwd.cu``; on a CPU tensor it runs
``flash_attention_plain``, which computes the same function with plain
tensor ops. There is no fallback from one to the other.

Semantics (both versions): q ``[B, Sq, H, d]``, k/v ``[B, Sk, Hkv, d]``;
query row i may attend kv column j when ``j < kv_length[b]`` and, if
``causal``, ``j <= i + q_offset``; rows with no such column emit 0 (the
TPU kernel's ``l == 0`` rule); GQA maps head h to kv head ``h // n_rep``;
softmax and accumulation in fp32, output in q's dtype; the optional
logsumexp is ``[B, H, Sq]`` fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .attention import repeat_kv_heads

NEG_INF = -1e30


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_length: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    if scale is None:
        scale = d**-0.5
    kf = repeat_kv_heads(k, n_rep).float()
    vf = repeat_kv_heads(v, n_rep).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    cols = torch.arange(sk, device=q.device)
    mask = torch.ones((b, 1, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        rows = torch.arange(sq, device=q.device) + q_offset
        mask = mask & (cols[None, :] <= rows[:, None])[None, None]
    if kv_length is not None:
        mask = mask & (cols[None, :] < kv_length[:, None])[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / torch.where(l == 0, 1.0, l), vf)
    out = out.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0, NEG_INF, m + torch.log(torch.where(l == 0, 1.0, l)))
    return out, lse[..., 0]


def _check(name: str, t: torch.Tensor, dtype, ndim: int, align: int = 16) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"flash_attention: {name} must be a contiguous {ndim}-d {dtype} "
            f"tensor, got {tuple(t.shape)} {t.dtype} "
            f"contiguous={t.is_contiguous()}"
        )
    if t.data_ptr() % align:
        raise ValueError(f"flash_attention: {name} must be {align}-byte aligned")


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, d]
    k: torch.Tensor,  # [B, Sk, Hkv, d]
    v: torch.Tensor,  # [B, Sk, Hkv, d]
    *,
    kv_length: Optional[torch.Tensor] = None,  # [B] int32
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Fused attention (see the module docstring). Returns ``out`` or
    ``(out, lse)`` with ``return_lse``."""
    args = dict(kv_length=kv_length, causal=causal, scale=scale,
                q_offset=q_offset, return_lse=return_lse)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **args)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    if q.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, 4)
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}")
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not match"
        )
    if d not in (64, 128) or hkv == 0 or h % hkv:
        raise ValueError(
            f"flash_attention: head_dim must be 64 or 128 and H a multiple "
            f"of Hkv, got d={d} H={h} Hkv={hkv}"
        )
    if q_offset < 0:
        raise ValueError("flash_attention: q_offset must be >= 0")
    if kv_length is not None:
        _check("kv_length", kv_length, torch.int32, 1, align=4)
        if kv_length.shape[0] != b or kv_length.device != q.device:
            raise ValueError("flash_attention: kv_length must be [B] on q's device")
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = kernels.load_library().lib
    code = lib.flash_attention_fwd(
        kernels.ptr(q), kernels.ptr(k), kernels.ptr(v),
        None if kv_length is None else kernels.ptr(kv_length),
        kernels.ptr(out), None if lse is None else kernels.ptr(lse),
        b, sq, sk, h, hkv, d, int(causal), int(q_offset), float(scale),
        kernels.DTYPE_CODES[q.dtype], kernels.stream_of(q),
    )
    kernels.check(code, "flash_attention_fwd")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
