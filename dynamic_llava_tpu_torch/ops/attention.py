"""Attention: the plain reference paths and the dispatchers.

Counterpart of ``dynamic_llava_tpu/ops/attention.py``. ``attend`` and
``decode_attend_appended`` are the semantically definitive plain versions
(fp32 scores and softmax) that the hand-written kernels are held against.
The dispatchers send every CUDA tensor to a kernel: causal self-attention
to K1 (``ops.flash_attention``, whose backward is K3), training-mode
policy attention to K4 (``ops.flash_policy``) and decode attention to K2
(``ops.decode_attention``), whose M-query form serves the chunk attention
of the continuation prefill (``extend_attend_appended``). The TPU size
thresholds that chose between XLA and Pallas there were measured on a v5e
and do not apply on the H100. ``decode_attend_appended`` and
``extend_attend_appended`` also serve the int8 (scale-folding) and fp8
caches and the sliding window. ``attend_with_policy`` and
``blockwise_attend`` are the plain
differentiable policy paths; the second is also K4's backward.

Layouts are the JAX ones: ``[B, S, H, d]``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

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
    bias: Optional[torch.Tensor] = None,  # [B|1, H, Sq, Sk] additive (ALiBi)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain masked attention, fp32 scores and softmax; ``[B, Sq, H, d]``
    in q's dtype. A fully masked row averages v uniformly (the -1e30
    fill), exactly as the JAX oracle does. ``bias`` is added to the scaled
    logits before the mask: the MPT family's ALiBi, which takes this path
    only (the flash kernels are rope-only), as in the JAX package."""
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv_heads(k, n_rep)
    v = repeat_kv_heads(v, n_rep)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def attend_with_policy(
    q: torch.Tensor,  # [B, S, H, d]
    k: torch.Tensor,  # [B, S, Hkv, d]
    v: torch.Tensor,  # [B, S, Hkv, d]
    policy: torch.Tensor,  # [B, S] in [0, 1]: soft keep mask over kv tokens
    *,
    mask: Optional[torch.Tensor] = None,  # [B, 1, S, S] bool
    scale: Optional[float] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Training-mode policy attention:
    ``w = (exp(logits - max) * policy_kv + eps/N) / (sum + eps)``, where the
    kv policy has its diagonal forced to 1 (every token may attend itself)
    and masked logits contribute ``exp(-inf) = 0``. The whole
    renormalization runs in fp32 whatever the input dtype."""
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv_heads(k, n_rep)
    v = repeat_kv_heads(v, n_rep)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, -torch.inf)
    pol = policy.float()[:, None, None, :]
    eye = torch.eye(s, dtype=torch.float32, device=q.device)[None, None]
    pol = pol + (1.0 - pol) * eye
    m = logits.amax(dim=-1, keepdim=True)
    # a fully masked row (a padding query) has max = -inf
    m = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.exp(logits - m) * pol
    w = (w + eps / s) / (w.sum(dim=-1, keepdim=True) + eps)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def blockwise_attend(
    q: torch.Tensor,  # [B, S, H, d]
    k: torch.Tensor,  # [B, S, Hkv, d]
    v: torch.Tensor,  # [B, S, Hkv, d]
    *,
    policy: Optional[torch.Tensor] = None,  # [B, S]
    kv_length: Optional[torch.Tensor] = None,  # [B]
    scale: Optional[float] = None,
    block_q: int = 256,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Causal (policy) attention computed one q block at a time, each block
    under ``torch.utils.checkpoint``: peak memory is O(block_q x S) instead
    of O(S^2) in the forward and in the backward. The plain differentiable
    path, and the gradient recompute behind kernel K4."""
    b, s, h, d = q.shape
    n_rep = h // k.shape[2]
    # fp32 K^T [B, H, d, S] and V [B, H, S, d], laid out once for every block
    kt = repeat_kv_heads(k, n_rep).float().permute(0, 2, 3, 1).contiguous()
    vt = repeat_kv_heads(v, n_rep).float().permute(0, 2, 1, 3).contiguous()
    if scale is None:
        scale = d**-0.5
    block_q = min(block_q, s)
    cols = torch.arange(s, dtype=torch.int32, device=q.device)
    polf = None if policy is None else policy.float()

    def block(qi, kt, vt, polf, start: int):
        rows = start + torch.arange(qi.shape[1], dtype=torch.int32, device=q.device)
        logits = torch.matmul(qi.float().transpose(1, 2), kt) * scale  # [B, H, bq, S]
        mask = (rows[:, None] >= cols[None, :])[None, None]
        if kv_length is not None:
            mask = mask & (cols[None, None, None, :] < kv_length[:, None, None, None])
        if polf is None:
            w = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        else:
            logits = torch.where(mask, logits, -torch.inf)
            diag = (rows[:, None] == cols[None, :])[None, None]
            pol = torch.where(diag, 1.0, polf[:, None, None, :])
            m = logits.amax(dim=-1, keepdim=True)
            m = torch.where(torch.isfinite(m), m, 0.0)
            e = torch.exp(logits - m) * pol
            w = (e + eps / s) / (e.sum(dim=-1, keepdim=True) + eps)
        return torch.matmul(w, vt).transpose(1, 2).to(q.dtype)  # [B, bq, H, d]

    need_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, policy))
    outs = []
    for start in range(0, s, block_q):
        qi = q[:, start:start + block_q]
        if need_grad:
            outs.append(checkpoint(block, qi, kt, vt, polf, start, use_reentrant=False))
        else:
            outs.append(block(qi, kt, vt, polf, start))
    return torch.cat(outs, dim=1)


def self_attend(
    q: torch.Tensor,  # [B, S, H, d]
    k: torch.Tensor,  # [B, S, Hkv, d]
    v: torch.Tensor,  # [B, S, Hkv, d]
    *,
    valid_len: Optional[torch.Tensor] = None,  # [B] int32: kv cols >= valid_len masked
    policy: Optional[torch.Tensor] = None,  # [B, S] soft keep mask (training)
) -> torch.Tensor:
    """Causal self-attention dispatcher, differentiable on every route.
    Without a policy: kernel K1 (backward K3) on a CUDA tensor, their plain
    versions on a CPU tensor; rows past ``valid_len`` are padding and never
    read downstream. With a policy and no ``valid_len``: kernel K4 (backward
    by blockwise recompute), plain on the CPU; with both, the plain
    ``attend_with_policy`` under the combined mask, as in the JAX package."""
    if policy is None:
        from .flash_attention import flash_attention_vjp

        return flash_attention_vjp(q, k, v, kv_length=valid_len, causal=True)
    if valid_len is None:
        from .flash_policy import flash_policy_attention_vjp

        return flash_policy_attention_vjp(q, k, v, policy)
    b, s = q.shape[:2]
    mask = make_attention_mask(s, s, causal=True, kv_length=valid_len, batch=b,
                               device=q.device)
    return attend_with_policy(q, k, v, policy, mask=mask)


def sliding_window_mask(
    q_pos: torch.Tensor,  # [B, Sq] int32 query positions
    k_pos: torch.Tensor,  # [B, Sk] or [Sk] int32 key positions
    window: int,
) -> torch.Tensor:
    """``[B, 1, Sq, Sk]`` True where ``q_pos - k_pos < window`` (Mistral
    semantics: a token attends itself and the previous ``window - 1``
    POSITIONS; combine with a causal mask for the lower bound)."""
    if k_pos.dim() == 1:
        k_pos = k_pos[None]
    return (q_pos[:, :, None] - k_pos[:, None, :] < window)[:, None]


def _fold_kv_scales(scales: torch.Tensor, n_rep: int) -> torch.Tensor:
    """``[B, max_len, Hkv]`` per-vector int8-KV scales -> ``[B, H, 1,
    max_len]`` fp32 multiplier over the score / probability row."""
    s = repeat_kv_heads(scales[..., None], n_rep)[..., 0]
    return s.float().permute(0, 2, 1)[:, :, None, :]


def decode_attend_appended(
    q: torch.Tensor,  # [B, 1, H, d] current-step query
    k_cache: torch.Tensor,  # [B, max_len, Hkv, d] persisted tokens (read-only)
    v_cache: torch.Tensor,  # [B, max_len, Hkv, d]
    k_cur: torch.Tensor,  # [B, 1, Hkv, d] current token's key (NOT in the cache)
    v_cur: torch.Tensor,  # [B, 1, Hkv, d]
    kv_length: torch.Tensor,  # [B] int32 attend bound (the persisted length)
    *,
    scale: Optional[float] = None,
    window: Optional[int] = None,  # sliding window; needs q_pos (dense cache)
    q_pos: Optional[torch.Tensor] = None,  # [B] current token's position
    k_scale: Optional[torch.Tensor] = None,  # [B, max_len, Hkv] int8-KV scales
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention with the current token appended virtually: the
    same as writing it at slot ``kv_length`` and attending over
    ``[0, kv_length + 1)``, but the cache is only read. Plain version of
    kernel K2.

    The cache may be stored in q's dtype, in fp8 (a plain cast to q's dtype
    on read) or in scaled int8 with ``k_scale`` / ``v_scale``, which are
    folded algebraically and never dequantize the cache:
    ``q . (k_i s_i) == (q . k_i) s_i`` applies the K scale to the fp32
    score row after the product, and ``sum p_i (v_i s_i) == sum (p_i s_i)
    v_i`` folds the V scale into the probabilities. With ``window`` a cache
    column ``j`` (slot = position in a dense cache) is visible iff
    ``q_pos - j < window``; the current token always is."""
    n_rep = q.shape[2] // k_cache.shape[2]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    max_len = k_cache.shape[1]
    qf = q.float()
    kc = repeat_kv_heads(k_cache.to(q.dtype), n_rep).float()
    vc = repeat_kv_heads(v_cache.to(q.dtype), n_rep).float()
    logits_cache = torch.einsum("bqhd,bkhd->bhqk", qf, kc) * scale
    if k_scale is not None:
        logits_cache = logits_cache * _fold_kv_scales(k_scale, n_rep)
    cols = torch.arange(max_len, dtype=torch.int32, device=q.device)
    mask = cols[None, None, None, :] < kv_length[:, None, None, None]
    if window is not None:
        mask = mask & sliding_window_mask(q_pos[:, None], cols, window)
    logits_cache = torch.where(mask, logits_cache, NEG_INF)
    kn = repeat_kv_heads(k_cur, n_rep).float()
    vn = repeat_kv_heads(v_cur, n_rep).float()
    logit_cur = torch.einsum("bqhd,bkhd->bhqk", qf, kn) * scale  # always visible
    w = torch.softmax(torch.cat([logits_cache, logit_cur], dim=-1), dim=-1)
    w_cache = w[..., :max_len]
    if v_scale is not None:
        w_cache = w_cache * _fold_kv_scales(v_scale, n_rep)
    out = torch.einsum("bhqk,bkhd->bqhd", w_cache, vc) + torch.einsum(
        "bhqk,bkhd->bqhd", w[..., max_len:], vn
    )
    return out.to(q.dtype)


def extend_attend_appended(
    q: torch.Tensor,  # [B, M, H, d] chunk queries
    k_cache: torch.Tensor,  # [B, max_len, Hkv, d] persisted (read-only; may be int8 / fp8)
    v_cache: torch.Tensor,  # [B, max_len, Hkv, d]
    k_chunk: torch.Tensor,  # [B, M, Hkv, d] the chunk's fresh keys
    v_chunk: torch.Tensor,  # [B, M, Hkv, d]
    mask: torch.Tensor,  # [B, 1, M, max_len + M] bool (cache cols ++ chunk cols)
    *,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # [B, max_len, Hkv] int8-KV scales
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunk attention over cache ++ chunk without concatenating the K/V:
    the M-token form of ``decode_attend_appended`` and the plain version of
    the M-query form of kernel K2. fp32 scores over the two segments, one
    softmax under ``mask``, out in q's dtype. The cache is cast to q's
    dtype on read (fp8 exactly); scaled-int8 storage folds ``k_scale`` into
    the fp32 score row and ``v_scale`` into the probabilities."""
    n_rep = q.shape[2] // k_cache.shape[2]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    max_len = k_cache.shape[1]
    qf = q.float()
    kc = repeat_kv_heads(k_cache.to(q.dtype), n_rep).float()
    vc = repeat_kv_heads(v_cache.to(q.dtype), n_rep).float()
    logits_cache = torch.einsum("bqhd,bkhd->bhqk", qf, kc) * scale  # [B, H, M, max_len]
    if k_scale is not None:
        logits_cache = logits_cache * _fold_kv_scales(k_scale, n_rep)
    kn = repeat_kv_heads(k_chunk, n_rep).float()
    vn = repeat_kv_heads(v_chunk, n_rep).float()
    logits_chunk = torch.einsum("bqhd,bkhd->bhqk", qf, kn) * scale  # [B, H, M, M]
    logits = torch.where(mask, torch.cat([logits_cache, logits_chunk], dim=-1), NEG_INF)
    w = torch.softmax(logits, dim=-1)
    w_cache = w[..., :max_len]
    if v_scale is not None:
        w_cache = w_cache * _fold_kv_scales(v_scale, n_rep)
    out = torch.einsum("bhqk,bkhd->bqhd", w_cache, vc) + torch.einsum(
        "bhqk,bkhd->bqhd", w[..., max_len:], vn
    )
    return out.to(q.dtype)
