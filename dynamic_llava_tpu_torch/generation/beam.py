"""Beam search over the static tiered cache (counterpart of
``dynamic_llava_tpu/generation/beam.py``).

Beams live on the batch axis (B = W), and reordering them is one gather
along that axis of every cache buffer. The loop is eager, as the JAX one
is: a ``decode_step`` a token (K2 on the card), the top-W choice and the
reorder between steps.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..config import LlavaConfig
from ..models import dynamic
from ..ops.kv_cache import KVCache, TieredCache


def reorder_cache(cache: TieredCache, beam_idx: torch.Tensor) -> TieredCache:
    """Gather beams along the batch axis (axis 1 of ``[L, B, ...]``); new
    tensors, the given cache is left as it was."""
    idx = beam_idx.long()

    def reorder_tier(t: KVCache) -> KVCache:
        return KVCache(*(None if a is None else a[:, idx] for a in t))

    return TieredCache(pre=reorder_tier(cache.pre), post=reorder_tier(cache.post))


def reorder_state(state: dynamic.GenState, beam_idx: torch.Tensor) -> dynamic.GenState:
    idx = beam_idx.long()
    return dynamic.GenState(
        cache=reorder_cache(state.cache, idx),
        next_pos=state.next_pos[idx],
        last_logits=state.last_logits[idx],
        ring_base=None if state.ring_base is None else state.ring_base[idx],
        ring_base_pre=None if state.ring_base_pre is None else state.ring_base_pre[idx],
    )


@torch.inference_mode()
def beam_search(
    params,
    cfg: LlavaConfig,
    state: dynamic.GenState,  # prefilled with batch == num_beams (the same prompt)
    num_beams: int,
    max_new_tokens: int,
    eos_token_id: int = 2,
    length_penalty: float = 1.0,
) -> List[int]:
    """Single-prompt beam search: ``state`` holds ``num_beams`` copies of the
    prompt (prefill the plan repeated). Returns the best token list: the
    best finished beam by length-normalised score, or, when none finished,
    the best live one. Ties in the top-W choice go to the lower flat index,
    as ``jax.lax.top_k`` gives them."""
    if state.ring_base is not None:
        # the decode below is drop-mode; on a ring-sized cache it would
        # force-drop everything past the window
        raise ValueError("beam_search requires a drop-mode (non-ring) state")
    w = num_beams
    dev = state.last_logits.device
    neg = -1e9
    # beam 0 starts live, the rest muted: the first expansion takes the
    # top-W distinct tokens of one distribution
    scores = torch.where(torch.arange(w, device=dev) == 0, 0.0, neg).to(torch.float32)
    tokens = np.zeros((w, max_new_tokens), np.int32)
    final: List[tuple] = []
    logits = state.last_logits
    for step in range(max_new_tokens):
        logp = torch.log_softmax(logits.float(), dim=-1)  # [W, V]
        v = logp.shape[-1]
        flat = (scores[:, None] + logp).reshape(-1)
        order = torch.sort(flat, descending=True, stable=True)
        top_scores, top_idx = order.values[:w], order.indices[:w]
        beam_idx, tok = top_idx // v, top_idx % v
        state = reorder_state(state, beam_idx)
        tokens = tokens[beam_idx.cpu().numpy()]
        tok_np = tok.cpu().numpy()
        tokens[:, step] = tok_np
        scores = top_scores.clone()
        for i in range(w):
            if tok_np[i] == eos_token_id:
                length = step + 1
                final.append((float(scores[i]) / (length**length_penalty),
                              tokens[i, :length].tolist()))
                scores[i] = neg
        if len(final) >= w or step == max_new_tokens - 1:
            break
        state = dynamic.decode_step(params, cfg, tok, state)
        logits = state.last_logits

    if not final:
        return tokens[int(torch.argmax(scores))].tolist()
    final.sort(key=lambda t: -t[0])
    return final[0][1]


@torch.inference_mode()
def sequence_logprob(params, cfg: LlavaConfig, state: dynamic.GenState,
                     tokens: Sequence[int]) -> float:
    """Sum of the greedy-path log-probabilities of ``tokens`` fed one by one
    after the prefilled one-sample ``state`` (``decode_step``, drop mode):
    the score ``beam_search`` ranks by, for any continuation."""
    total = 0.0
    for j, t in enumerate(tokens):
        total += float(torch.log_softmax(state.last_logits[0].float(), dim=-1)[int(t)])
        if j + 1 < len(tokens):
            tok = torch.full((1,), int(t), dtype=torch.long, device=state.last_logits.device)
            state = dynamic.decode_step(params, cfg, tok, state)
    return total
