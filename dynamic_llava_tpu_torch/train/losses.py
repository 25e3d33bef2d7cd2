"""Training losses: LM cross-entropy and the keep-ratio MSE terms
(counterpart of ``dynamic_llava_tpu/train/losses.py``).

* CE over shifted logits, mean over the non-ignored tokens, in fp32.
* For each active predictor, the per-sample keep ratio over its span,
  squared error against the target keep rate, mean over the batch, scaled
  by ``mask_loss_weight``. A sample whose span is empty (or shorter than
  the training threshold, which empties it) contributes 0 but still counts
  in the batch mean.

Under a mesh every rank holds its own rows and the means are global: the
sums and counts are summed over ``data`` (``parallel.sharding.data_sum``)
before the division, never a mean of per-rank means.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import LlamaConfig, SparseConfig
from ..constants import IGNORE_INDEX
from ..models import llama
from ..models.dynamic import TrainForwardOut
from ..parallel.sharding import data_size, data_sum


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of the token NLLs over the non-ignored labels, their count)."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = torch.gather(logits.float(), -1, safe[..., None])[..., 0]
    return torch.where(valid, lse - tgt, 0.0).sum(), valid.sum()


def lm_cross_entropy(
    logits: torch.Tensor,  # [B, S, V] fp32
    labels: torch.Tensor,  # [B, S] int with IGNORE_INDEX
) -> torch.Tensor:
    total, n = _nll_sum(logits[:, :-1], labels[:, 1:])
    return data_sum(total) / data_sum(n).clamp(min=1)


def lm_cross_entropy_blockwise(
    llm_params,
    tcfg: LlamaConfig,
    hidden: torch.Tensor,  # [B, S, D] final decoder hidden states (before the final norm)
    labels: torch.Tensor,  # [B, S] int with IGNORE_INDEX
    block_s: int = 256,
) -> torch.Tensor:
    """Chunked CE that never holds the ``[B, S, V]`` fp32 logits: the
    lm_head projection, the logsumexp and the target gather run one
    sequence block at a time, each block under ``torch.utils.checkpoint``,
    so forward and backward peak at ``[B, block_s, V]``. The same numbers
    as ``lm_cross_entropy(lm_head(hidden), labels)``."""
    x = hidden[:, :-1]
    y = labels[:, 1:]
    s = x.shape[1]
    block_s = min(block_s, s)

    def block(xi, yi):
        return _nll_sum(llama.lm_head(llm_params, tcfg, xi), yi)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for start in range(0, s, block_s):
        xi, yi = x[:, start:start + block_s], y[:, start:start + block_s]
        if torch.is_grad_enabled():
            ds, dn = checkpoint(block, xi, yi, use_reentrant=False)
        else:
            ds, dn = block(xi, yi)
        total, n = total + ds, n + dn
    return data_sum(total) / data_sum(n).clamp(min=1)


def _span_ratio_loss(
    mask: torch.Tensor,  # [B, S] keep mask (1.0 outside the span)
    span: torch.Tensor,  # [B, S] bool: where the predictor acted
    target_rate: float,
) -> torch.Tensor:
    """mean_B (target - per-sample span keep ratio)^2, zero for empty spans."""
    count = span.sum(dim=1)
    ratio = (mask * span).sum(dim=1) / count.clamp(min=1)
    sqerr = torch.where(count > 0, (target_rate - ratio) ** 2, 0.0)
    return data_sum(sqerr.sum()) / (sqerr.shape[0] * data_size())


def total_loss(
    out: TrainForwardOut,
    labels: torch.Tensor,
    sparse: SparseConfig,
    llm_params=None,
    tcfg: Optional[LlamaConfig] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """With ``out.logits`` present, the dense CE. When the forward ran with
    ``return_hidden=True`` (``out.hidden`` set), pass ``llm_params`` and
    ``tcfg`` and the CE runs blockwise."""
    if out.logits is None:
        ce = lm_cross_entropy_blockwise(llm_params, tcfg, out.hidden, labels)
    else:
        ce = lm_cross_entropy(out.logits, labels)
    metrics = {"lm_loss": ce}
    loss = ce
    w = sparse.mask_loss_weight
    for name, mask, span, rate in (
        ("image_mask_loss", out.image_mask, out.image_span, sparse.vision_keep_rate),
        ("output_text_mask_loss", out.output_text_mask, out.answer_span,
         sparse.output_text_keep_rate),
        ("instruct_mask_loss", out.instruct_mask, out.instruct_span,
         sparse.instruct_keep_rate),
    ):
        if mask is not None:
            term = _span_ratio_loss(mask, span, rate)
            metrics[name] = term
            loss = loss + w * term
    metrics["loss"] = loss
    return loss, metrics
