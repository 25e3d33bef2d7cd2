"""Multimodal embedding fusion and segment indexing (counterpart of
``dynamic_llava_tpu/multimodal/fusion.py``, of which the host-side planner
here is the port's own copy).

1. **Host-side planning** (numpy): per sample, locate the
   ``IMAGE_TOKEN_INDEX`` sentinel, lay out the fused sequence (text tokens
   with the sentinel replaced by ``num_image_tokens`` slots), compute the
   segment spans the sparsifier needs (image, answer, last-instruct, the
   last found by scanning for the tokenized ``"USER:"``), clamp on
   truncation and right-pad. The output is a ``FusionPlan`` of
   static-shape integer arrays.
2. **Device-side fusion** (``fuse_embeddings``): one gather of projected
   image features and a select.

Span semantics: ``image`` = [image_start, image_end), ``answer`` =
[answer_start, valid_len) where answer_start is the position after the
last label == IGNORE_INDEX.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX

# tokenized "USER:" under the vicuna/llama tokenizer (the original
# Dynamic-LLaVA ``special_text``)
VICUNA_USER_TOKENS = (11889, 29901)


class SegmentSpans(NamedTuple):
    """Per-sample [B] int32 span boundaries in fused-sequence coordinates.

    Empty spans have start == end. ``has_image`` disambiguates text-only
    samples (their image span is empty).
    """

    image_start: np.ndarray
    image_end: np.ndarray
    answer_start: np.ndarray
    answer_end: np.ndarray
    last_instruct_start: np.ndarray
    last_instruct_end: np.ndarray
    has_image: np.ndarray  # [B] bool


class FusionPlan(NamedTuple):
    """Static-shape splice plan for a batch (right-padded to S)."""

    token_ids: np.ndarray  # [B, S] int32 text token at each slot (0 at image/pad slots)
    is_image: np.ndarray  # [B, S] bool — slot holds an image token
    image_slot: np.ndarray  # [B, S] int32 index into the image-feature axis (0 elsewhere)
    labels: np.ndarray  # [B, S] int32 (IGNORE_INDEX at non-answer slots)
    positions: np.ndarray  # [B, S] int32 (= arange; padding irrelevant)
    valid_len: np.ndarray  # [B] int32
    spans: SegmentSpans

    @property
    def batch(self) -> int:
        return self.token_ids.shape[0]

    @property
    def seq_len(self) -> int:
        return self.token_ids.shape[1]


def _find_subsequence_last(hay: np.ndarray, needle: Sequence[int]) -> int:
    """Index of the last occurrence of ``needle`` in ``hay`` or -1."""
    n = len(needle)
    if n == 0 or len(hay) < n:
        return -1
    windows = np.lib.stride_tricks.sliding_window_view(hay, n)
    hits = np.nonzero((windows == np.asarray(needle)).all(axis=1))[0]
    return int(hits[-1]) if len(hits) else -1


def plan_sample(
    input_ids: np.ndarray,  # [L] int, may contain IMAGE_TOKEN_INDEX sentinels
    num_image_tokens: int,
    labels: Optional[np.ndarray] = None,  # [L] int
    max_length: Optional[int] = None,
    user_tokens: Sequence[int] = VICUNA_USER_TOKENS,
    tokens_per_image: Optional[Sequence[int]] = None,  # per-sentinel counts (anyres)
):
    """Fused layout for one sample. Returns (token_ids, is_image, image_slot,
    labels, span dict) as 1-D numpy arrays of the fused length.

    Multiple sentinels are supported (as the original multi-image handling): each expands to its own span; the image
    feature axis is the per-sample concatenation of all images' tokens. The
    recorded ``image_start/end`` span (used by the vision predictor) covers
    the FIRST image — the sparsification recipe is single-image, matching
    the reference training data.
    """
    input_ids = np.asarray(input_ids, np.int32)
    if labels is None:
        labels = np.full_like(input_ids, IGNORE_INDEX)
    labels = np.asarray(labels, np.int32)

    img_pos = np.nonzero(input_ids == IMAGE_TOKEN_INDEX)[0]
    n_images = len(img_pos)
    if tokens_per_image is None:
        tokens_per_image = [num_image_tokens] * n_images
    assert len(tokens_per_image) == n_images

    if n_images:
        fused_len = len(input_ids) - n_images + int(sum(tokens_per_image))
        token_ids = np.zeros(fused_len, np.int32)
        is_image = np.zeros(fused_len, bool)
        image_slot = np.zeros(fused_len, np.int32)
        new_labels = np.full(fused_len, IGNORE_INDEX, np.int32)
        src = dst = slot = 0
        image_start = image_end = None
        for p, n_tok in zip(img_pos, tokens_per_image):
            seg = int(p) - src
            token_ids[dst : dst + seg] = input_ids[src : src + seg]
            new_labels[dst : dst + seg] = labels[src : src + seg]
            dst += seg
            src += seg + 1  # skip the sentinel
            is_image[dst : dst + n_tok] = True
            image_slot[dst : dst + n_tok] = slot + np.arange(n_tok)
            if image_start is None:
                image_start, image_end = dst, dst + n_tok
            slot += n_tok
            dst += n_tok
        tail = len(input_ids) - src
        token_ids[dst : dst + tail] = input_ids[src:]
        new_labels[dst : dst + tail] = labels[src:]
    else:
        token_ids = input_ids.copy()
        is_image = np.zeros(len(input_ids), bool)
        image_slot = np.zeros(len(input_ids), np.int32)
        new_labels = labels.copy()
        image_start = image_end = 0
        fused_len = len(input_ids)

    if max_length is not None and fused_len > max_length:
        token_ids = token_ids[:max_length]
        is_image = is_image[:max_length]
        image_slot = image_slot[:max_length]
        new_labels = new_labels[:max_length]
        fused_len = max_length
        image_start = min(image_start, max_length)
        image_end = min(image_end, max_length)

    # answer span: after the last ignored label (as in the original). For
    # inference (labels all ignored) the span is empty and decode-time
    # bookkeeping takes over.
    supervised = np.nonzero(new_labels != IGNORE_INDEX)[0]
    if len(supervised):
        ignored_before = np.nonzero(new_labels == IGNORE_INDEX)[0]
        answer_start = int(ignored_before[-1]) + 1 if len(ignored_before) else 0
        answer_end = fused_len
    else:
        answer_start = answer_end = fused_len

    # last_instruct: from the last "USER:" occurrence to the answer start
    # (fused coordinates; token scan happens on the text slots)
    scan_ids = np.where(is_image, -1, token_ids)
    li = _find_subsequence_last(scan_ids, user_tokens)
    if li >= 0:
        last_instruct_start = li
        last_instruct_end = answer_start if answer_start < fused_len else fused_len
    else:
        last_instruct_start = last_instruct_end = image_end

    spans = dict(
        image_start=image_start,
        image_end=image_end,
        answer_start=answer_start,
        answer_end=answer_end,
        last_instruct_start=last_instruct_start,
        last_instruct_end=last_instruct_end,
        has_image=len(img_pos) == 1,
    )
    return token_ids, is_image, image_slot, new_labels, spans


def plan_batch(
    input_ids_list: List[np.ndarray],
    num_image_tokens: int,
    labels_list: Optional[List[np.ndarray]] = None,
    max_length: Optional[int] = None,
    pad_to: Optional[int] = None,
    user_tokens: Sequence[int] = VICUNA_USER_TOKENS,
    tokens_per_image_list: Optional[List[Sequence[int]]] = None,
    pad_multiple: Optional[int] = None,
) -> FusionPlan:
    """Right-padded batch plan (reference pads right for training and
    computes per-sample index shifts; our plan is already per-slot so no
    shifting is needed). ``tokens_per_image_list`` supplies variable
    per-image token counts (anyres tiling). ``pad_multiple`` rounds the
    padded length up to a bucket so nearby prompt lengths share one compiled
    program (ignored when ``pad_to`` is given)."""
    if labels_list is None:
        labels_list = [None] * len(input_ids_list)
    if tokens_per_image_list is None:
        tokens_per_image_list = [None] * len(input_ids_list)
    rows = [
        plan_sample(ids, num_image_tokens, lab, max_length, user_tokens, tpi)
        for ids, lab, tpi in zip(
            input_ids_list, labels_list, tokens_per_image_list
        )
    ]
    b = len(rows)
    lens = [len(r[0]) for r in rows]
    s = pad_to or max(lens)
    if pad_to is None and pad_multiple and pad_multiple > 1:
        s = -(-s // pad_multiple) * pad_multiple
    assert max(lens) <= s, f"pad_to={s} < max fused len {max(lens)}"

    token_ids = np.zeros((b, s), np.int32)
    is_image = np.zeros((b, s), bool)
    image_slot = np.zeros((b, s), np.int32)
    labels = np.full((b, s), IGNORE_INDEX, np.int32)
    span_fields = {
        k: np.zeros((b,), np.int32)
        for k in (
            "image_start", "image_end", "answer_start", "answer_end",
            "last_instruct_start", "last_instruct_end",
        )
    }
    has_image = np.zeros((b,), bool)
    for i, (tid, isi, slot, lab, sp) in enumerate(rows):
        L = lens[i]
        token_ids[i, :L] = tid
        is_image[i, :L] = isi
        image_slot[i, :L] = slot
        labels[i, :L] = lab
        for k in span_fields:
            span_fields[k][i] = sp[k]
        has_image[i] = sp["has_image"]

    positions = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    return FusionPlan(
        token_ids=token_ids,
        is_image=is_image,
        image_slot=image_slot,
        labels=labels,
        positions=positions,
        valid_len=np.asarray(lens, np.int32),
        spans=SegmentSpans(**span_fields, has_image=has_image),
    )


def fuse_embeddings(
    text_embeds: torch.Tensor,  # [B, S, D] embedding lookup of plan.token_ids
    image_features: torch.Tensor,  # [B, N_img, D] projected tower output
    plan_is_image: torch.Tensor,  # [B, S] bool
    plan_image_slot: torch.Tensor,  # [B, S] index into the image-feature axis
) -> torch.Tensor:
    """Projected image features at image slots, text embeddings elsewhere."""
    b = text_embeds.shape[0]
    bidx = torch.arange(b, device=text_embeds.device)[:, None]
    img = image_features[bidx, plan_image_slot.long()]  # [B, S, D]
    return torch.where(plan_is_image[:, :, None], img.to(text_embeds.dtype), text_embeds)
