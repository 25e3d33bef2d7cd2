"""Fused attention, forward and backward: kernels K1 and K3 and their
plain PyTorch versions.

Counterpart of ``dynamic_llava_tpu/ops/flash_attention.py``
(``flash_attention`` over the Pallas ``_flash_kernel``, ``flash_attention_bwd``
over ``_flash_bwd_dkv_kernel`` and ``_flash_bwd_dq_kernel``, and
``flash_attention_vjp``). On a CUDA tensor ``flash_attention`` launches the
hand-written Hopper kernel ``csrc/flash_attention_fwd.cu`` and
``flash_attention_bwd`` the three kernels of ``csrc/flash_attention_bwd.cu``
(delta, dq, dk/dv); on a CPU tensor they run ``flash_attention_plain`` and
``flash_attention_bwd_plain``, which compute the same functions with plain
tensor ops. There is no fallback from one to the other. The C entry points
run bf16 tensors on the tensor cores and fp32 tensors in full fp32.
``flash_attention_vjp`` is the differentiable entry: a
``torch.autograd.Function`` whose forward is K1 (saving the logsumexp) and
whose backward is K3.

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


def check_qkv(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What every attention kernel here asks of its CUDA inputs: one
    supported dtype, contiguous 4-d tensors on one device, matching shapes,
    head_dim 64 or 128, H a multiple of Hkv."""
    if q.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"{what}: unsupported dtype {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, 4)
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}")
    b, _, h, d = q.shape
    hkv = k.shape[2]
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"{what}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not match"
        )
    if d not in (64, 128) or hkv == 0 or h % hkv:
        raise ValueError(
            f"{what}: head_dim must be 64 or 128 and H a multiple "
            f"of Hkv, got d={d} H={h} Hkv={hkv}"
        )


def _check_kv_length(kv_length: torch.Tensor, q: torch.Tensor) -> None:
    _check("kv_length", kv_length, torch.int32, 1, align=4)
    if kv_length.shape[0] != q.shape[0] or kv_length.device != q.device:
        raise ValueError("flash_attention: kv_length must be [B] on q's device")


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
    check_qkv("flash_attention", q, k, v)
    if q_offset < 0:
        raise ValueError("flash_attention: q_offset must be >= 0")
    if kv_length is not None:
        _check_kv_length(kv_length, q)
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


# ---------------------------------------------------------------------------
# Backward (kernel K3)
# ---------------------------------------------------------------------------


def _delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` as ``[B, H, Sq]`` fp32: the plain version of
    ``flash_attention_bwd_delta``."""
    return (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _sum_groups(dx_h: torch.Tensor, hkv: int, dtype) -> torch.Tensor:
    """Per-query-head fp32 ``[B, Sk, H, d]`` -> ``[B, Sk, Hkv, d]``: the sum
    over each GQA group, then the cast."""
    b, sk, h, d = dx_h.shape
    if h == hkv:
        return dx_h.to(dtype)
    return dx_h.reshape(b, sk, hkv, h // hkv, d).sum(dim=3).to(dtype)


def flash_attention_bwd_plain(
    q: torch.Tensor,  # [B, Sq, H, d]
    k: torch.Tensor,  # [B, Sk, Hkv, d]
    v: torch.Tensor,  # [B, Sk, Hkv, d]
    out: torch.Tensor,  # [B, Sq, H, d] the forward's output
    lse: torch.Tensor,  # [B, H, Sq] fp32 the forward's logsumexp
    g: torch.Tensor,  # [B, Sq, H, d] gradient of the output
    *,
    kv_length: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
):
    """``(dq, dk, dv)`` from the saved logsumexp, the arithmetic of the K3
    kernels with plain tensor ops (the S x S matrices do exist here)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = h // hkv
    if scale is None:
        scale = d**-0.5
    qf, gf = q.float(), g.float()
    kf = repeat_kv_heads(k, n_rep).float()
    vf = repeat_kv_heads(v, n_rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    cols = torch.arange(sk, device=q.device)
    mask = torch.ones((b, 1, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        rows = torch.arange(sq, device=q.device)
        mask = mask & (cols[None, :] <= rows[:, None])[None, None]
    if kv_length is not None:
        mask = mask & (cols[None, :] < kv_length[:, None])[:, None, None, :]
    # the mask comes before the exponential: a fully masked row has
    # lse = NEG_INF and exp(s - lse) would overflow
    p = torch.exp(torch.where(mask, s - lse[..., None], -torch.inf))
    dv_h = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - _delta(out, g)[..., None]) * scale
    dk_h = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype)
    return dq, _sum_groups(dk_h, hkv, k.dtype), _sum_groups(dv_h, hkv, v.dtype)


def _bwd_args(q, k, v, g, lse, delta, kv_length, causal):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    check_qkv("flash_attention_bwd", q, k, v)
    _check("g", g, q.dtype, 4)
    if g.shape != q.shape or g.device != q.device:
        raise ValueError("flash_attention_bwd: g must have q's shape and device")
    for name, t in (("lse", lse), ("delta", delta)):
        _check(name, t, torch.float32, 3, align=4)
        if t.shape != (b, h, sq) or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be [B, H, Sq] on q's device")
    if kv_length is not None:
        _check_kv_length(kv_length, q)
    if causal and sq != sk:
        raise ValueError("flash_attention_bwd: the causal backward needs Sq == Sk")
    return [
        kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(g),
        kernels.ptr(lse), kernels.ptr(delta),
        None if kv_length is None else kernels.ptr(kv_length),
    ]


def flash_attention_bwd_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel K3, delta (CUDA tensors only): ``rowsum(dO * O)`` as
    ``[B, H, Sq]`` fp32, ``out`` and ``g`` read once."""
    if not out.is_cuda:
        raise ValueError(f"flash_attention_bwd_delta: not a CUDA tensor ({out.device})")
    if out.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"flash_attention_bwd_delta: unsupported dtype {out.dtype}")
    _check("out", out, out.dtype, 4)
    _check("g", g, out.dtype, 4)
    b, sq, h, d = out.shape
    if g.shape != out.shape or g.device != out.device or d not in (64, 128):
        raise ValueError(
            "flash_attention_bwd_delta: g must have out's shape and device and "
            f"head_dim must be 64 or 128, got {tuple(out.shape)} {tuple(g.shape)}")
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=out.device)
    code = kernels.load_library().lib.flash_attention_bwd_delta(
        kernels.ptr(out), kernels.ptr(g), kernels.ptr(delta), b, sq, h, d,
        kernels.DTYPE_CODES[out.dtype], kernels.stream_of(out),
    )
    kernels.check(code, "flash_attention_bwd_delta")
    flash_attention_bwd_delta.launches += 1
    return delta


def flash_attention_bwd_dq(q, k, v, g, lse, delta, *, kv_length=None,
                           causal=True, scale=None) -> torch.Tensor:
    """Kernel K3, dq half (CUDA tensors only): ``dq = ds k`` per q tile."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention_bwd_dq: not a CUDA tensor ({q.device})")
    head = _bwd_args(q, k, v, g, lse, delta, kv_length, causal)
    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    code = kernels.load_library().lib.flash_attention_bwd_dq(
        *head, kernels.ptr(dq), b, sq, k.shape[1], h, k.shape[2], d, int(causal),
        float(d**-0.5 if scale is None else scale),
        kernels.DTYPE_CODES[q.dtype], kernels.stream_of(q),
    )
    kernels.check(code, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, *, kv_length=None,
                            causal=True, scale=None):
    """Kernel K3, dk/dv half (CUDA tensors only): ``dv = p^T dO`` and
    ``dk = ds^T q`` per kv tile, summed in fp32 over the query heads of each
    GQA group inside the kernel (fixed order, no atomics) and written once
    as ``[B, Sk, Hkv, d]`` in k's dtype."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention_bwd_dkv: not a CUDA tensor ({q.device})")
    head = _bwd_args(q, k, v, g, lse, delta, kv_length, causal)
    b, sq, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = kernels.load_library().lib.flash_attention_bwd_dkv(
        *head, kernels.ptr(dk), kernels.ptr(dv), b, sq, k.shape[1], h, k.shape[2], d,
        int(causal), float(d**-0.5 if scale is None else scale),
        kernels.DTYPE_CODES[q.dtype], kernels.stream_of(q),
    )
    kernels.check(code, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_delta.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    *,
    kv_length: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
):
    """Flash backward ``(dq, dk, dv)`` (see ``flash_attention_bwd_plain``):
    the three K3 kernels on CUDA tensors, the plain version on CPU tensors."""
    args = dict(kv_length=kv_length, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, g, **args)
    g = g.contiguous()
    delta = flash_attention_bwd_delta(out, g)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, **args)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, **args)
    return dq, dk, dv


class _FlashAttentionFn(torch.autograd.Function):
    """K1 forward (saving q, k, v, kv_length, out, lse), K3 backward. Both
    are deterministic, so a layer re-run under activation checkpointing
    reproduces its first run."""

    @staticmethod
    def forward(ctx, q, k, v, kv_length, causal):
        out, lse = flash_attention(q, k, v, kv_length=kv_length, causal=causal,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, kv_length, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_length, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, kv_length=kv_length,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_vjp(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_length: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Differentiable fused attention: ``flash_attention`` whose gradient is
    ``flash_attention_bwd``. Without anything to differentiate it is
    ``flash_attention`` itself."""
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)):
        return flash_attention(q, k, v, kv_length=kv_length, causal=causal)
    return _FlashAttentionFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                   kv_length, causal)
