"""Dynamic-LLaVA: multimodal composition and sparsification, inference and
training forward (counterpart of ``dynamic_llava_tpu/models/dynamic.py``).

* ``prefill`` -- E1: the vision predictor scores the image tokens entering
  ``sparse_layer``, a static-budget top-k keeps ``vision_keep_budget`` of
  them, and the sequence is compacted in stable order; layers below the
  sparse layer cache the full sequence (pre tier), layers at and above the
  compacted one (post tier). The E2 instruct-predictor prune is ported too.
* ``decode_step`` -- E3: the output-text predictor decides, on the hidden
  state entering the sparse layer, whether the new token persists in the
  post tier. Once that tier's budget is full, ``kv_overflow="drop"``
  force-drops every further token and ``"ring"`` lets each new token evict
  the oldest decode entry (both tiers wrap, the prefill region protected).
* ``prefill_continue`` -- E5: a new round's chunk against the live cache in
  one pass (multi-round chat), ragged across the batch, with the
  instruct-predictor prune of the chunk before the post tier.
* ``forward_nocache_eval`` -- E4: the cache-free hard-pruned forward of
  the no-cache evaluation (the answer span pruned again on every call).
* ``decode_speculative_step`` -- one speculative round: M candidate tokens
  verified in one pass, equal to feeding them one by one through
  ``decode_step`` (drop mode), the caches rolled back by lengths to the
  accepted prefix.

* ``forward_train`` -- T1/T2/T3: the full-sequence training forward in
  which the predictors' Gumbel keep masks become a soft policy over the kv
  tokens of every layer from the sparse layer on.

With the predictors off (``DENSE_SPARSE_CONFIG``) all of them reduce to
dense LLaVA-1.5. ``prefill``'s ``vision_score_override`` and
``decode_step``'s ``output_text_keep_override`` replace a predictor's
decision for the random-pruning ablations.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..config import LlavaConfig
from ..multimodal.fusion import fuse_embeddings
from ..ops.gumbel import gumbel_keep_mask
from ..ops.kv_cache import TieredCache, advance_tiered, init_tiered_cache
from ..ops.sparsify import gather_tokens, plan_compaction, topk_keep_mask
from ..parallel.sharding import clip_param_specs, gather_tree
from . import clip, llama, projector
from .predictors import text_predictor, vision_predictor


def encode_images(params, cfg: LlavaConfig, pixel_values: torch.Tensor,
                  frozen_tower: bool = False) -> torch.Tensor:
    """Tower + projector: ``[B, H, W, 3]`` normalized NHWC -> ``[B, N_img, D]``.
    ``frozen_tower`` stops gradients at the tower features (the tower runs
    without an autograd graph) and leaves the projector trainable. Under a
    mesh the tower runs replicated on its gathered weights (the projector
    is replicated already)."""
    with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen_tower):
        feats = clip.vision_tower_features(
            gather_tree(params["vision_tower"], clip_param_specs()), cfg.vision, pixel_values)
    return projector.apply_projector(params["mm_projector"], feats)


def _span_mask(s: int, start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.int32, device=start.device)[None, :]
    return (pos >= start[:, None]) & (pos < end[:, None])


def _span_index(start: torch.Tensor, length: int) -> torch.Tensor:
    return start.long()[:, None] + torch.arange(length, device=start.device)[None, :]


def _gather_span(x: torch.Tensor, start: torch.Tensor, length: int) -> torch.Tensor:
    """``[B, S, D] -> [B, length, D]``: the per-sample span starting at
    ``start``. Positions past the end read the last row, as a JAX gather
    clamps them: a batch of text-only rows shorter than the image span
    (``image_start`` 0) gathers rows that nothing uses."""
    b = x.shape[0]
    idx = _span_index(start, length).clamp(max=x.shape[1] - 1)
    return x[torch.arange(b, device=x.device)[:, None], idx]


def _scatter_span(dst: torch.Tensor, start: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``dst`` ``[B, S]`` with ``values`` ``[B, L]`` written from ``start``
    on (out of place). Positions past the end are dropped, as a JAX scatter
    drops them."""
    b, s = dst.shape
    length = values.shape[1]
    room = torch.cat([dst, dst.new_zeros((b, length))], dim=1)
    return room.scatter(1, _span_index(start, length), values)[:, :s]


class GenState(NamedTuple):
    cache: TieredCache
    next_pos: torch.Tensor  # [B] original-position counter for RoPE
    last_logits: torch.Tensor  # [B, V] fp32 logits of the last processed token
    # ring-overflow mode only: each tier's prefill length per sample, the
    # protected region the decode ring never evicts; None in drop mode
    ring_base: Optional[torch.Tensor] = None  # [B] int32 (post tier)
    ring_base_pre: Optional[torch.Tensor] = None  # [B] int32 (pre tier)


class PrefillInfo(NamedTuple):
    image_keep_mask: Optional[torch.Tensor]  # [B, S] over pre-compaction slots
    kept_positions: torch.Tensor  # [B, S_c] original positions of compacted slots
    new_length: torch.Tensor  # [B] post-compaction valid length


def prefill(
    params,
    cfg: LlavaConfig,
    plan_token_ids: torch.Tensor,  # [B, S]
    plan_is_image: torch.Tensor,  # [B, S] bool
    plan_image_slot: torch.Tensor,  # [B, S]
    valid_len: torch.Tensor,  # [B] int32
    image_start: torch.Tensor,  # [B]
    last_instruct_start: torch.Tensor,  # [B]
    last_instruct_end: torch.Tensor,  # [B]
    has_image: torch.Tensor,  # [B] bool
    pixel_values: Optional[torch.Tensor],  # [B, H, W, 3] or None (text-only)
    cache: TieredCache,
    *,
    image_features: Optional[torch.Tensor] = None,  # [B, N_pad, D] pre-encoded
    all_have_image: bool = False,
    ring_mode: bool = False,  # records the ring bases for kv_overflow="ring"
    vision_score_override: Optional[torch.Tensor] = None,  # [B, N_img] ablation
) -> Tuple[GenState, PrefillInfo]:
    """``image_features`` replaces the tower for pre-encoded inputs (anyres
    tiling gives per-sample token counts that the planner already encodes
    in ``plan_image_slot``); ``pixel_values`` is then ignored, and the
    vision predictor, whose fixed-span top-k assumes the standard tower, is
    skipped, as in the JAX ``prefill``.

    ``all_have_image`` is the host-known promise that every sample has
    exactly one image; only then may the compacted sequence be cut to
    ``S - N_img + K`` (a text-only sample keeps all its tokens). The
    options are keyword-only: the JAX ``prefill`` has ``image_features`` in
    the next positional slot, so a positional call written for it raises
    here instead of misbinding.

    ``vision_score_override`` is an evaluation hook (the ablations of
    ``run/sparse_quality.py`` in the JAX package): it replaces the vision
    predictor's scores, so random pruning runs the same top-k and
    compaction."""
    tcfg, sparse = cfg.text, cfg.sparse
    b, s = plan_token_ids.shape
    n_img = cfg.num_image_tokens
    dev = plan_token_ids.device

    x = llama.embed_tokens(params["llm"], plan_token_ids)
    if image_features is not None:
        x = fuse_embeddings(x, image_features, plan_is_image, plan_image_slot)
        pixel_values = None
    elif pixel_values is not None:
        img_feats = encode_images(params, cfg, pixel_values)
        x = fuse_embeddings(x, img_feats, plan_is_image, plan_image_slot)
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)

    sl = sparse.sparse_layer
    res = llama.run_layers_prefill(
        params["llm"], tcfg, x, positions, cache.pre, valid_len, lo=0, hi=sl
    )
    x, cache_pre = res.x, res.cache

    valid = positions < valid_len[:, None]
    keep = valid
    image_keep = None
    out_len = s
    if sparse.use_vision_predictor and pixel_values is not None:
        if vision_score_override is not None:
            scores_img = vision_score_override.float()
        else:
            img_hidden = _gather_span(x, image_start, n_img)  # [B, N_img, D]
            logits = vision_predictor(
                params["predictors"]["image_score_predictor"], img_hidden, sparse
            )
            scores_img = torch.log_softmax(logits.float(), dim=-1)[..., 0]
        scores = _scatter_span(torch.zeros((b, s), dtype=torch.float32, device=dev),
                               image_start, scores_img)
        k_budget = sparse.vision_keep_budget(n_img)
        img_keep = topk_keep_mask(scores, k_budget, plan_is_image & valid)
        # samples without an image keep their (empty) image span untouched
        keep = torch.where(has_image[:, None] & plan_is_image, img_keep, keep)
        image_keep = img_keep
        if all_have_image:
            out_len = s - n_img + k_budget

    if sparse.use_instruct_predictor:
        tp = text_predictor(params["predictors"]["instruct_score_predictor"], x)
        instr_keep = tp[..., 0] > tp[..., 1]
        instr_span = _span_mask(s, last_instruct_start, last_instruct_end)
        is_span_last = (
            torch.arange(s, dtype=torch.int32, device=dev)[None, :]
            == (last_instruct_end - 1)[:, None]
        )
        keep = torch.where(instr_span & ~is_span_last, keep & instr_keep, keep)

    if sparse.use_vision_predictor or sparse.use_instruct_predictor:
        comp = plan_compaction(keep, out_len=out_len)
        x = gather_tokens(x, comp.gather_idx)
        new_positions = gather_tokens(positions, comp.gather_idx)
        new_valid = comp.new_length
    else:
        new_positions = positions
        new_valid = valid_len

    # the post tier may be allocated at the pruned budget: cut the padded
    # compacted sequence to its capacity before writing
    post_cap = cache.post.max_len
    if x.shape[1] > post_cap:
        x = x[:, :post_cap]
        new_positions = new_positions[:, :post_cap]
    new_valid = torch.clamp(new_valid, max=x.shape[1]).to(torch.int32)
    res2 = llama.run_layers_prefill(
        params["llm"], tcfg, x, new_positions, cache.post, new_valid,
        lo=sl, hi=tcfg.num_hidden_layers,
    )
    x, cache_post = res2.x, res2.cache

    last_hidden = _gather_span(x, new_valid - 1, 1)  # [B, 1, D]
    logits = llama.lm_head(params["llm"], tcfg, last_hidden)[:, 0]
    state = GenState(
        cache=TieredCache(pre=cache_pre, post=cache_post),
        next_pos=valid_len.to(torch.int32),
        last_logits=logits,
        ring_base=new_valid if ring_mode else None,
        ring_base_pre=valid_len.to(torch.int32) if ring_mode else None,
    )
    info = PrefillInfo(
        image_keep_mask=image_keep,
        kept_positions=new_positions,
        new_length=new_valid,
    )
    return state, info


def _ring_slots(
    length: torch.Tensor,  # [B] persisted count (may exceed the budget)
    base: torch.Tensor,  # [B] protected prefill region bound
    budget: int,  # tier capacity minus the scratch slot
    active: Optional[torch.Tensor],
):
    """Shared ring arithmetic: ``(attend_bound, write_slot, wrapped)``.
    Below the budget this is the append-at-length protocol exactly; past it
    the write slot rotates over ``[base, budget)``, so each new token evicts
    the oldest decode-region entry, and the attend bound saturates at the
    budget. Frozen samples write to the scratch slot (never attended)."""
    cap = torch.clamp(budget - base, min=1)
    wrapped = length >= budget
    slot = torch.where(
        wrapped, base + torch.remainder(length - base, cap), length
    ).to(torch.int32)
    if active is not None:
        slot = torch.where(active, slot, budget)
    return torch.clamp(length, max=budget), slot, wrapped


def decode_step(
    params,
    cfg: LlavaConfig,
    token: torch.Tensor,  # [B] next input token ids
    state: GenState,
    active: Optional[torch.Tensor] = None,  # [B] bool -- False freezes the sample
    kv_overflow: str = "drop",  # "drop" | "ring"
    output_text_keep_override: Optional[torch.Tensor] = None,  # [B] ablation
) -> GenState:
    """One decode step. The K/V buffers of both tiers are updated IN PLACE
    (the JAX version returns rebuilt buffers); lengths and positions come
    back as new tensors.

    ``active=False`` samples are frozen: the token's K/V lands in a slot
    that is never persisted, lengths and positions do not advance, and
    ``last_logits`` keeps its previous value. ``kv_overflow`` picks the
    full-budget policy: ``"drop"`` force-drops further tokens (they attend
    from the scratch slot this step and are never persisted); ``"ring"``
    persists EVERY token past the wrap by overwriting the oldest
    decode-region entry, in both tiers, each at its own budget
    (``state.ring_base`` / ``ring_base_pre`` from ``prefill(ring_mode=True)``
    protect the prefill region). ``output_text_keep_override`` is an
    evaluation hook (``run/text_sparse_quality.py`` in the JAX package): it
    replaces the output-text predictor's keep decision, so random KV
    dropping runs the same persist and advance path."""
    tcfg, sparse = cfg.text, cfg.sparse
    b = token.shape[0]
    sl = sparse.sparse_layer
    if kv_overflow not in ("drop", "ring"):
        raise ValueError(f"kv_overflow must be 'drop' or 'ring', got {kv_overflow!r}")
    if kv_overflow == "ring" and tcfg.sliding_window is not None:
        # a wrapped ring breaks the slot == position invariant of the window
        # mask, and a sliding window already is a recency ring
        raise ValueError("kv_overflow='ring' is incompatible with sliding_window")

    x = llama.embed_tokens(params["llm"], token[:, None])
    pos = state.next_pos[:, None]

    pre_bound = pre_slot = None
    if (kv_overflow == "ring" and state.ring_base_pre is not None
            and state.cache.pre.num_layers > 0):
        pre_bound, pre_slot, _ = _ring_slots(
            state.cache.pre.length[0], state.ring_base_pre,
            state.cache.pre.max_len - 1, active,
        )
    d1 = llama.run_layers_decode(
        params["llm"], tcfg, x, pos, state.cache.pre, lo=0, hi=sl,
        attend_bound=pre_bound, write_slot=pre_slot,
    )
    x = d1.x

    if output_text_keep_override is not None:
        keep = output_text_keep_override.to(torch.int32)
    elif sparse.use_output_text_predictor:
        # E3: keep iff logit[keep] > logit[drop] on the hidden entering the
        # sparse layer
        tp = text_predictor(
            params["predictors"]["output_text_score_predictor"], x[:, 0]
        )
        keep = (tp[..., 0] > tp[..., 1]).to(torch.int32)
    else:
        keep = torch.ones((b,), dtype=torch.int32, device=token.device)

    # the post tier reserves its last slot as scratch for the in-flight
    # token; once the budget is full the kv_overflow policy applies
    attend_bound = write_slot = None  # default: append at length
    if state.cache.post.num_layers > 0:
        post_budget = state.cache.post.max_len - 1
        cur_len = state.cache.post.length[0]
        if kv_overflow == "ring" and state.ring_base is not None:
            attend_bound, write_slot, wrapped = _ring_slots(
                cur_len, state.ring_base, post_budget, active
            )
            # past the wrap every token persists (evicting the oldest); the
            # predictor's decision still applies before it
            keep = torch.where(wrapped, 1, keep).to(torch.int32)
        else:
            keep = keep * (cur_len < post_budget).to(torch.int32)
    if active is not None:
        keep = keep * active.to(torch.int32)

    d2 = llama.run_layers_decode(
        params["llm"], tcfg, x, pos, state.cache.post,
        lo=sl, hi=tcfg.num_hidden_layers,
        attend_bound=attend_bound, write_slot=write_slot,
    )
    cache = advance_tiered(TieredCache(pre=d1.cache, post=d2.cache), keep, active=active)
    logits = llama.lm_head(params["llm"], tcfg, d2.x)[:, 0]
    if active is not None:
        pos_inc = active.to(state.next_pos.dtype)
        logits = torch.where(active[:, None], logits, state.last_logits)
    else:
        pos_inc = 1
    return state._replace(cache=cache, next_pos=state.next_pos + pos_inc,
                          last_logits=logits)


def prefill_continue(
    params,
    cfg: LlavaConfig,
    token_ids: torch.Tensor,  # [B, M] the new round's tokens (right-padded)
    state: GenState,
    chunk_len: Optional[torch.Tensor] = None,  # [B] valid tokens a sample
) -> GenState:
    """Multi-round continuation (E5): a new chunk against the live cache in
    one pass (``run_layers_extend`` in both tiers; K/V written IN PLACE into
    the state's buffers, lengths and positions returned as new tensors).
    The pre tier persists every valid token. With the instruct predictor on,
    the post tier persists only the chunk tokens it keeps, the last valid
    token always.

    ``chunk_len`` makes the batch ragged: padding tokens are never
    persisted, positions and lengths advance by the valid count, and the
    logits come from each sample's last valid token. A ``chunk_len`` of 0
    makes the sample a no-op (nothing persisted, positions unchanged, its
    logits meaningless). Omitted, every chunk is fully valid. The ring
    markers pass through: the extend path never wraps (once a tier is full,
    chunk tokens are force-dropped), so multi-round sessions use
    ``kv_overflow="drop"``."""
    tcfg, sparse = cfg.text, cfg.sparse
    b, m = token_ids.shape
    sl = sparse.sparse_layer
    dev = token_ids.device
    cols = torch.arange(m, dtype=torch.int32, device=dev)[None, :]
    valid = None if chunk_len is None else cols < chunk_len[:, None]  # [B, M]

    x = llama.embed_tokens(params["llm"], token_ids)
    positions = state.next_pos[:, None].to(torch.int32) + cols

    d1 = llama.run_layers_extend(
        params["llm"], tcfg, x, positions, state.cache.pre, lo=0, hi=sl, keep=valid,
    )
    x = d1.x
    # the runner's kept counts reflect its capacity clamp: lengths never pass
    # what was persisted
    cache_pre = d1.cache._replace(length=d1.cache.length + d1.kept[None, :])

    keep = valid
    if sparse.use_instruct_predictor:
        tp = text_predictor(params["predictors"]["instruct_score_predictor"], x)
        keep = tp[..., 0] > tp[..., 1]
        if valid is not None:
            # the last VALID token is forced kept; a chunk_len of 0 forces
            # nothing (column -1 would wrap to a padding token)
            is_last_valid = (cols == (chunk_len - 1)[:, None]) & (chunk_len >= 1)[:, None]
            keep = (keep & valid) | is_last_valid
        else:
            keep = keep.clone()
            keep[:, -1] = True

    d2 = llama.run_layers_extend(
        params["llm"], tcfg, x, positions, state.cache.post,
        lo=sl, hi=tcfg.num_hidden_layers, keep=keep,
    )
    x = d2.x
    cache_post = d2.cache._replace(length=d2.cache.length + d2.kept[None, :])

    if chunk_len is not None:
        # a chunk_len of 0 gathers row 0 (in bounds, meaningless) and
        # advances by 0
        last = _gather_span(x, torch.clamp(chunk_len - 1, min=0), 1)  # [B, 1, D]
        advance = chunk_len.to(state.next_pos.dtype)
    else:
        last = x[:, -1:]
        advance = m
    logits = llama.lm_head(params["llm"], tcfg, last)[:, 0]
    return GenState(
        cache=TieredCache(pre=cache_pre, post=cache_post),
        next_pos=state.next_pos + advance,
        last_logits=logits,
        ring_base=state.ring_base,
        ring_base_pre=state.ring_base_pre,
    )


def forward_nocache_eval(
    params,
    cfg: LlavaConfig,
    plan_token_ids: torch.Tensor,  # [B, S]
    plan_is_image: torch.Tensor,  # [B, S] bool
    plan_image_slot: torch.Tensor,  # [B, S]
    valid_len: torch.Tensor,  # [B] int32
    image_start: torch.Tensor,  # [B]
    answer_start: torch.Tensor,  # [B]
    last_instruct_start: torch.Tensor,  # [B]
    last_instruct_end: torch.Tensor,  # [B]
    has_image: torch.Tensor,  # [B] bool
    pixel_values: Optional[torch.Tensor],  # [B, H, W, 3] or None (text-only)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """E4: the cache-free hard-pruned forward (the no-cache bench's
    quadratic-recompute regime). The image tokens are top-k pruned; unlike
    ``prefill``, the answer span ``[answer_start, valid_len - 1)`` is pruned
    again from scratch by the output-text predictor's threshold on every
    call, the last token always kept; then the instruct prune, the
    compaction, and layers from the sparse layer on over the kept tokens.

    Returns ``(last-token logits [B, V] fp32, kept lengths [B])``."""
    tcfg, sparse = cfg.text, cfg.sparse
    b, s = plan_token_ids.shape
    n_img = cfg.num_image_tokens
    sl = sparse.sparse_layer
    dev = plan_token_ids.device

    x = llama.embed_tokens(params["llm"], plan_token_ids)
    if pixel_values is not None:
        img_feats = encode_images(params, cfg, pixel_values)
        x = fuse_embeddings(x, img_feats, plan_is_image, plan_image_slot)
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)

    x = llama.run_layers_nocache(params["llm"], tcfg, x, positions, lo=0, hi=sl)

    valid = positions < valid_len[:, None]
    keep = valid
    if sparse.use_vision_predictor and pixel_values is not None:
        img_hidden = _gather_span(x, image_start, n_img)
        logits = vision_predictor(
            params["predictors"]["image_score_predictor"], img_hidden, sparse
        )
        scores_img = torch.log_softmax(logits.float(), dim=-1)[..., 0]
        scores = _scatter_span(torch.zeros((b, s), dtype=torch.float32, device=dev),
                               image_start, scores_img)
        img_keep = topk_keep_mask(
            scores, sparse.vision_keep_budget(n_img), plan_is_image & valid)
        keep = torch.where(has_image[:, None] & plan_is_image, img_keep, keep)

    if sparse.use_output_text_predictor:
        tp = text_predictor(params["predictors"]["output_text_score_predictor"], x)
        ans_span = _span_mask(s, answer_start, valid_len - 1)  # the last token exempt
        keep = torch.where(ans_span, keep & (tp[..., 0] > tp[..., 1]), keep)

    if sparse.use_instruct_predictor:
        tp = text_predictor(params["predictors"]["instruct_score_predictor"], x)
        ins_span = _span_mask(s, last_instruct_start, last_instruct_end)
        is_last = (torch.arange(s, dtype=torch.int32, device=dev)[None, :]
                   == (last_instruct_end - 1)[:, None])
        keep = torch.where(ins_span & ~is_last, keep & (tp[..., 0] > tp[..., 1]), keep)

    comp = plan_compaction(keep)
    x = gather_tokens(x, comp.gather_idx)
    new_positions = gather_tokens(positions, comp.gather_idx)
    x = llama.run_layers_nocache(
        params["llm"], tcfg, x, new_positions, lo=sl, hi=tcfg.num_hidden_layers)
    last_hidden = _gather_span(x, comp.new_length - 1, 1)
    logits = llama.lm_head(params["llm"], tcfg, last_hidden)[:, 0]
    return logits, comp.new_length


def decode_speculative_step(
    params,
    cfg: LlavaConfig,
    tokens: torch.Tensor,  # [B, M]: [next committed token, draft_1 .. draft_{M-1}]
    state: GenState,
    eos_token_id: int,
    active: Optional[torch.Tensor] = None,  # [B] bool -- False freezes the sample
) -> Tuple[GenState, torch.Tensor, torch.Tensor]:
    """One speculative round: the M candidates verified in ONE pass
    (``run_layers_extend`` in both tiers, K2-M on the card), exactly
    equivalent to feeding them one by one through ``decode_step`` in drop
    mode. ``tokens[:, 0]`` is the model's own next token (the argmax of
    ``state.last_logits``, always accepted), ``tokens[:, 1:]`` drafts from
    any source.

    The pre tier persists every candidate; the output-text predictor's keep
    and the post tier's capacity force-drop (cumulative over the chunk, the
    rule the per-token steps apply one at a time) decide the post tier's,
    and a dropped candidate is invisible to the later ones
    (``chunk_attend``). The longest prefix on which the drafts equal the
    argmax chain is accepted, cut at the first EOS input and never past
    what the pre tier persisted; the caches are rolled back to it by lengths
    alone (rejected K/V lie past the lengths and are never attended). K/V are
    written IN PLACE; lengths, ``next_pos`` and ``last_logits`` come back as
    new tensors, ``last_logits`` from the last accepted row.

    Returns ``(state2, n_acc [B] int32, next_tok [B] int32)``: the accepted
    inputs (>= 1 for an active sample, 0 for a frozen one, whose state is
    left as it was) and the token after the accepted prefix. With M == 1 it
    is a greedy ``decode_step``. A drop-mode contract: a ring state raises."""
    tcfg, sparse = cfg.text, cfg.sparse
    if state.ring_base is not None:
        raise ValueError("speculative decode requires drop mode (a ring-mode state was given)")
    b, m = tokens.shape
    sl = sparse.sparse_layer
    dev = tokens.device
    i32 = torch.int32

    x = llama.embed_tokens(params["llm"], tokens)
    positions = state.next_pos[:, None].to(i32) + torch.arange(m, dtype=i32, device=dev)[None]
    valid = None if active is None else active[:, None].expand(b, m)

    d1 = llama.run_layers_extend(
        params["llm"], tcfg, x, positions, state.cache.pre, lo=0, hi=sl, keep=valid,
    )
    x = d1.x

    # E3 per candidate, on the hidden entering the sparse layer (the same as
    # the per-token path's: the pre tier persists everything)
    if sparse.use_output_text_predictor:
        tp = text_predictor(params["predictors"]["output_text_score_predictor"], x)
        keep = tp[..., 0] > tp[..., 1]  # [B, M]
    else:
        keep = torch.ones((b, m), dtype=torch.bool, device=dev)
    # the capacity force-drop, here because chunk_attend must reflect it
    if state.cache.post.num_layers > 0:
        offsets = torch.cumsum(keep.to(i32), dim=1, dtype=i32) - 1
        remaining = torch.clamp(state.cache.post.max_len - 1 - state.cache.post.length[0], min=0)
        keep = keep & (offsets < remaining[:, None])
    if valid is not None:
        keep = keep & valid

    d2 = llama.run_layers_extend(
        params["llm"], tcfg, x, positions, state.cache.post,
        lo=sl, hi=tcfg.num_hidden_layers, keep=keep, chunk_attend=keep,
    )
    logits_all = llama.lm_head(params["llm"], tcfg, d2.x)  # [B, M, V] fp32
    am = torch.argmax(logits_all, dim=-1).to(i32)  # [B, M]

    # input i >= 1 is accepted iff it is the argmax after input i - 1 and
    # every input before it was accepted
    if m > 1:
        matches = (tokens[:, 1:].to(i32) == am[:, :-1]).to(i32)
        n_acc = 1 + torch.cumprod(matches, dim=1, dtype=i32).sum(dim=1, dtype=i32)
    else:
        n_acc = torch.ones(b, dtype=i32, device=dev)
    # EOS is accepted, nothing after it
    is_eos = (tokens == eos_token_id).to(i32)
    first_eos = torch.argmax(is_eos, dim=1).to(i32)
    n_acc = torch.where(is_eos.any(dim=1), torch.minimum(n_acc, first_eos + 1), n_acc)
    # never past what the pre tier persisted (its clamp fires only on an
    # undersized cache)
    n_acc = torch.minimum(n_acc, d1.kept)
    if active is not None:
        n_acc = torch.where(active, n_acc, 0).to(i32)

    idx = torch.clamp(n_acc - 1, min=0).long()[:, None]  # [B, 1]
    kept_cum = torch.cumsum(keep.to(i32), dim=1, dtype=i32)
    kept_acc = torch.where(n_acc > 0, torch.gather(kept_cum, 1, idx)[:, 0], 0).to(i32)
    cache_pre = d1.cache._replace(length=d1.cache.length + n_acc[None, :])
    cache_post = d2.cache._replace(length=d2.cache.length + kept_acc[None, :])

    last = torch.gather(logits_all, 1, idx[..., None].expand(b, 1, logits_all.shape[-1]))[:, 0]
    next_tok = torch.gather(am, 1, idx)[:, 0]
    if active is not None:
        last = torch.where(active[:, None], last, state.last_logits)
    state2 = state._replace(cache=TieredCache(pre=cache_pre, post=cache_post),
                            next_pos=state.next_pos + n_acc, last_logits=last)
    return state2, n_acc, next_tok


class TrainForwardOut(NamedTuple):
    logits: Optional[torch.Tensor]  # [B, S, V] fp32 (None with return_hidden)
    hidden: Optional[torch.Tensor]  # [B, S, D] final hidden (return_hidden only)
    image_mask: Optional[torch.Tensor]  # [B, S] gumbel keep over image slots (1 elsewhere)
    output_text_mask: Optional[torch.Tensor]  # [B, S]
    instruct_mask: Optional[torch.Tensor]  # [B, S]
    image_span: Optional[torch.Tensor]  # [B, S] bool
    answer_span: Optional[torch.Tensor]  # [B, S] bool (only where the predictor applied)
    instruct_span: Optional[torch.Tensor]  # [B, S] bool


def forward_train(
    params,
    cfg: LlavaConfig,
    plan_token_ids: torch.Tensor,
    plan_is_image: torch.Tensor,
    plan_image_slot: torch.Tensor,
    valid_len: torch.Tensor,
    image_start: torch.Tensor,
    answer_start: torch.Tensor,
    answer_end: torch.Tensor,
    last_instruct_start: torch.Tensor,
    last_instruct_end: torch.Tensor,
    has_image: torch.Tensor,
    pixel_values: Optional[torch.Tensor],
    noise: Union[torch.Generator, Sequence[torch.Tensor]],
    gumbel_tau: Union[float, torch.Tensor],
    remat: bool = True,
    remat_policy: str = "nothing",
    return_hidden: bool = False,
    layer_runner=None,
) -> TrainForwardOut:
    """Full-sequence training forward with Gumbel policy masks (T1/T2/T3).

    ``noise`` is a ``torch.Generator`` on the tensors' device, or the three
    uniform tensors themselves, for the vision, output-text and instruct
    predictors: ``[B, N_img, 2]``, ``[B, S, 2]``, ``[B, S, 2]`` (an unused
    one may be None). ``return_hidden=True`` skips the lm_head and returns
    the final hidden states, so that the loss can run the blockwise CE
    without the ``[B, S, V]`` fp32 logits ever existing.

    ``layer_runner`` overrides how the two decoder layer ranges run (the
    signature of ``llama.run_layers_nocache``): the hook pipeline
    parallelism plugs into (``parallel.pipeline.make_layer_runner``)."""
    tcfg, sparse = cfg.text, cfg.sparse
    b, s = plan_token_ids.shape
    n_img = cfg.num_image_tokens
    sl = sparse.sparse_layer
    dev = plan_token_ids.device
    noises = (noise,) * 3 if isinstance(noise, torch.Generator) else tuple(noise)

    x = llama.embed_tokens(params["llm"], plan_token_ids)
    if pixel_values is not None:
        img_feats = encode_images(params, cfg, pixel_values, frozen_tower=True)
        x = fuse_embeddings(x, img_feats, plan_is_image, plan_image_slot)
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)

    run_layers = layer_runner or llama.run_layers_nocache
    x = run_layers(
        params["llm"], tcfg, x, positions, lo=0, hi=sl, remat=remat,
        remat_policy=remat_policy,
    )

    valid = positions < valid_len[:, None]
    policy = torch.ones((b, s), dtype=torch.float32, device=dev)
    image_mask = output_text_mask = instruct_mask = None
    image_span = answer_span = instruct_span = None

    if sparse.use_vision_predictor and pixel_values is not None:
        # T1: gumbel keep mask over the image tokens
        img_hidden = _gather_span(x, image_start, n_img)
        logits = vision_predictor(
            params["predictors"]["image_score_predictor"], img_hidden, sparse
        )
        keep = gumbel_keep_mask(noises[0], logits, gumbel_tau)  # [B, N_img]
        mask_full = _scatter_span(torch.ones((b, s), dtype=torch.float32, device=dev),
                                  image_start, keep)
        image_span = plan_is_image & valid & has_image[:, None]
        mask_full = torch.where(image_span, mask_full, 1.0)
        policy = policy * mask_full
        image_mask = mask_full

    def text_mask(name: str, u, start, end, min_len: int):
        # T2 / T3: gumbel keep over a span; spans shorter than the training
        # threshold are force-kept
        tp = text_predictor(params["predictors"][name], x)
        keep = gumbel_keep_mask(u, tp, gumbel_tau)  # [B, S]
        long_enough = (end - start) >= min_len
        span = _span_mask(s, start, end) & valid & long_enough[:, None]
        return torch.where(span, keep, 1.0), span

    if sparse.use_output_text_predictor:
        output_text_mask, answer_span = text_mask(
            "output_text_score_predictor", noises[1], answer_start, answer_end,
            sparse.output_text_len_for_training)
        policy = policy * output_text_mask
    if sparse.use_instruct_predictor:
        instruct_mask, instruct_span = text_mask(
            "instruct_score_predictor", noises[2], last_instruct_start,
            last_instruct_end, sparse.instruct_len_for_training)
        policy = policy * instruct_mask

    x = run_layers(
        params["llm"], tcfg, x, positions, lo=sl, hi=tcfg.num_hidden_layers,
        policy=policy if sparse.any_predictor else None,
        remat=remat, remat_policy=remat_policy,
    )
    logits = None if return_hidden else llama.lm_head(params["llm"], tcfg, x)
    return TrainForwardOut(
        logits=logits,
        hidden=x if return_hidden else None,
        image_mask=image_mask,
        output_text_mask=output_text_mask,
        instruct_mask=instruct_mask,
        image_span=image_span,
        answer_span=answer_span,
        instruct_span=instruct_span,
    )


# gen_cache_sizes is a verbatim copy of the JAX function: the post-tier
# capacity decides when decode tokens are force-dropped, so any sizing
# difference would break token-exact parity.
def gen_cache_sizes(cfg: LlavaConfig, prompt_len: int, max_new_tokens: int,
                    margin: int = 8,
                    bound_output_budget: bool = True,
                    all_have_image: bool = True,
                    bucket: int = 1,
                    decode_window: Optional[int] = None,
                    ring: bool = False) -> Tuple[int, int]:
    """Static cache capacities: the pre tier holds everything; the post tier
    is sized by the pruned prefill budget + decode headroom
    (``keep_rate * max_new + margin`` + 1 scratch slot with
    ``bound_output_budget``). ``all_have_image`` must be False for batches
    that may contain text-only samples. ``bucket`` rounds both capacities
    up to a multiple. ``decode_window`` caps the post tier's decode
    headroom; ``ring`` also caps the pre tier (ring mode only)."""
    pre_headroom = max_new_tokens
    if ring and decode_window is not None:
        pre_headroom = min(max_new_tokens, decode_window)
    pre = prompt_len + pre_headroom + margin
    sparse = cfg.sparse
    post_prefill = prompt_len
    if sparse.use_vision_predictor and all_have_image:
        n_img = cfg.num_image_tokens
        post_prefill = prompt_len - n_img + sparse.vision_keep_budget(n_img)
    decode_headroom = max_new_tokens
    if bound_output_budget and sparse.use_output_text_predictor:
        decode_headroom = int(
            max_new_tokens * sparse.output_text_keep_rate
        ) + margin
    if decode_window is not None:
        decode_headroom = min(decode_headroom, decode_window)
    post = post_prefill + decode_headroom + margin + 1
    if bucket > 1:
        pre = -(-pre // bucket) * bucket
        post = -(-post // bucket) * bucket
    return pre, post


def make_gen_cache(
    cfg: LlavaConfig, batch: int, prompt_len: int, max_new_tokens: int,
    dtype=torch.bfloat16, bound_output_budget: bool = True,
    all_have_image: bool = True, bucket: int = 1,
    decode_window: Optional[int] = None, ring: bool = False,
    device=None,
) -> TieredCache:
    """The tiered cache for a generation. Under a mesh, ``batch`` is the
    rows this rank holds and the cache holds its KV heads."""
    pre, post = gen_cache_sizes(
        cfg, prompt_len, max_new_tokens,
        bound_output_budget=bound_output_budget,
        all_have_image=all_have_image, bucket=bucket,
        decode_window=decode_window, ring=ring,
    )
    return init_tiered_cache(
        cfg.text, cfg.sparse.sparse_layer, batch, pre, post, dtype, device
    )
