"""Static-budget token selection and stable compaction (counterpart of
``dynamic_llava_tpu/ops/sparsify.py``).

Kept tokens stay in ascending original order, so plain causal masking on
the compacted sequence equals causal masking by original position.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def topk_keep_mask(
    scores: torch.Tensor,  # [B, S] float; higher = keep
    budget: int,
    candidate_mask: torch.Tensor,  # [B, S] bool: only these compete
) -> torch.Tensor:
    """Bool ``[B, S]`` mask of the top-``budget`` candidates per sample.

    Ties go to the LOWER index, as ``jax.lax.top_k`` promises.
    ``torch.topk`` makes no such promise on CUDA, so this is a stable
    descending sort instead."""
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(candidate_mask, scores, neg)
    idx = torch.argsort(masked, dim=1, descending=True, stable=True)[:, :budget]
    keep = torch.zeros_like(candidate_mask).scatter_(1, idx, True)
    return keep & candidate_mask


class Compacted(NamedTuple):
    gather_idx: torch.Tensor  # [B, S_out] original index of each output slot
    new_length: torch.Tensor  # [B] int32 kept-token count
    valid: torch.Tensor  # [B, S_out] bool: slot holds a kept token


def plan_compaction(
    keep_mask: torch.Tensor,  # [B, S] bool
    out_len: Optional[int] = None,
) -> Compacted:
    """Stable gather plan that left-aligns kept tokens in original order;
    ``out_len`` truncates the padded tail."""
    s = keep_mask.shape[1]
    order = torch.argsort((~keep_mask).to(torch.uint8), dim=1, stable=True)
    new_length = keep_mask.sum(dim=1, dtype=torch.int32)
    if out_len is None:
        out_len = s
    order = order[:, :out_len]
    slots = torch.arange(out_len, dtype=torch.int32, device=keep_mask.device)
    return Compacted(
        gather_idx=order,
        new_length=new_length,
        valid=slots[None, :] < new_length[:, None],
    )


def gather_tokens(x: torch.Tensor, gather_idx: torch.Tensor) -> torch.Tensor:
    """Apply a compaction plan to a ``[B, S, ...]`` (or ``[B, S]``) tensor."""
    idx = gather_idx.long()
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]
    )
    return torch.gather(x, 1, idx)


def remap_span_starts(
    span_pos: torch.Tensor,  # [B] int original position
    keep_mask: torch.Tensor,  # [B, S] bool
) -> torch.Tensor:
    """New index of an original position after compaction: the number of
    kept tokens strictly before it. ``[B]`` int32."""
    s = keep_mask.shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=keep_mask.device)[None, :]
    before = keep_mask & (pos < span_pos.to(torch.int32)[:, None])
    return before.sum(dim=1, dtype=torch.int32)
