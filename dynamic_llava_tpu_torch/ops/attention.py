"""Attention: the plain reference paths and the dispatchers.

Counterpart of ``dynamic_llava_tpu/ops/attention.py``. ``attend`` and
``decode_attend_appended`` are the semantically definitive plain versions
(fp32 scores and softmax) that the hand-written kernels are held against.
The dispatchers send every CUDA tensor to a kernel: prefill self-attention
to K1 (``ops.flash_attention``) and decode attention to K2
(``ops.decode_attention``). The TPU size thresholds that chose between XLA
and Pallas there were measured on a v5e and do not apply on the H100.

Layouts are the JAX ones: ``[B, S, H, d]``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv_heads(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA broadcast ``[B, S, Hkv, d] -> [B, S, Hkv*n_rep, d]``."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def make_attention_mask(
    q_len: int,
    kv_len: int,
    *,
    causal: bool,
    q_offset: Optional[torch.Tensor] = None,  # [B] int32: q row i is kv index q_offset+i
    kv_length: Optional[torch.Tensor] = None,  # [B] int32: valid kv slots are [0, kv_length)
    kv_valid: Optional[torch.Tensor] = None,  # [B, Sk] bool
    batch: int = 1,
    device=None,
) -> torch.Tensor:
    """Boolean ``[B, 1, Sq, Sk]`` mask (True = attend)."""
    rows = torch.arange(q_len, dtype=torch.int32, device=device)
    cols = torch.arange(kv_len, dtype=torch.int32, device=device)
    mask = torch.ones((batch, 1, q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        if q_offset is None:
            q_offset = torch.zeros((batch,), dtype=torch.int32, device=device)
        q_idx = q_offset[:, None] + rows[None, :]  # [B, Sq]
        mask = mask & (q_idx[:, :, None] >= cols[None, None, :])[:, None]
    if kv_length is not None:
        mask = mask & (cols[None, :] < kv_length[:, None])[:, None, None, :]
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :]
    return mask


def attend(
    q: torch.Tensor,  # [B, Sq, H, d]
    k: torch.Tensor,  # [B, Sk, Hkv, d]
    v: torch.Tensor,  # [B, Sk, Hkv, d]
    *,
    mask: Optional[torch.Tensor] = None,  # [B, 1, Sq, Sk] bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain masked attention, fp32 scores and softmax; ``[B, Sq, H, d]``
    in q's dtype. A fully masked row averages v uniformly (the -1e30
    fill), exactly as the JAX oracle does."""
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv_heads(k, n_rep)
    v = repeat_kv_heads(v, n_rep)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def self_attend(
    q: torch.Tensor,  # [B, S, H, d]
    k: torch.Tensor,  # [B, S, Hkv, d]
    v: torch.Tensor,  # [B, S, Hkv, d]
    *,
    valid_len: Optional[torch.Tensor] = None,  # [B] int32: kv cols >= valid_len masked
) -> torch.Tensor:
    """Causal prefill self-attention: kernel K1 on a CUDA tensor, its plain
    version on a CPU tensor. Rows past ``valid_len`` are padding and never
    read downstream."""
    from .flash_attention import flash_attention

    return flash_attention(q, k, v, kv_length=valid_len, causal=True)


def decode_attend_appended(
    q: torch.Tensor,  # [B, 1, H, d] current-step query
    k_cache: torch.Tensor,  # [B, max_len, Hkv, d] persisted tokens (read-only)
    v_cache: torch.Tensor,  # [B, max_len, Hkv, d]
    k_cur: torch.Tensor,  # [B, 1, Hkv, d] current token's key (NOT in the cache)
    v_cur: torch.Tensor,  # [B, 1, Hkv, d]
    kv_length: torch.Tensor,  # [B] int32 persisted length
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention with the current token appended virtually: the
    same as writing it at slot ``kv_length`` and attending over
    ``[0, kv_length + 1)``, but the cache is only read. Plain version of
    kernel K2 (bf16 storage; the int8 scale folding and the sliding window
    of the JAX function are not ported yet)."""
    n_rep = q.shape[2] // k_cache.shape[2]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    max_len = k_cache.shape[1]
    qf = q.float()
    kc = repeat_kv_heads(k_cache.to(q.dtype), n_rep).float()
    vc = repeat_kv_heads(v_cache.to(q.dtype), n_rep).float()
    logits_cache = torch.einsum("bqhd,bkhd->bhqk", qf, kc) * scale
    cols = torch.arange(max_len, device=q.device)
    mask = cols[None, None, None, :] < kv_length[:, None, None, None]
    logits_cache = torch.where(mask, logits_cache, NEG_INF)
    kn = repeat_kv_heads(k_cur, n_rep).float()
    vn = repeat_kv_heads(v_cur, n_rep).float()
    logit_cur = torch.einsum("bqhd,bkhd->bhqk", qf, kn) * scale  # always visible
    w = torch.softmax(torch.cat([logits_cache, logit_cur], dim=-1), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w[..., :max_len], vc) + torch.einsum(
        "bhqk,bkhd->bqhd", w[..., max_len:], vn
    )
    return out.to(q.dtype)
