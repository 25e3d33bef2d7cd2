"""Vision tokenizer initialization: the port's own copy of
``dynamic_llava_tpu/models/tokenizer_init.py``.

Add the image special tokens to the tokenizer, grow the embedding (rows)
and the lm_head (columns, stored ``[D, V]``), and initialize the new
entries with the mean of the existing ones, computed in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import LlamaConfig
from ..constants import DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN, DEFAULT_IMAGE_PATCH_TOKEN


def _grow(mat: torch.Tensor, n_new: int, dim: int) -> torch.Tensor:
    """``mat`` with ``n_new`` more entries along ``dim``, each the fp32 mean
    of the existing ones, in ``mat``'s dtype."""
    mean = mat.float().mean(dim=dim, keepdim=True).to(mat.dtype)
    shape = list(mat.shape)
    shape[dim] = n_new
    return torch.cat([mat, mean.expand(shape)], dim=dim)


def initialize_vision_tokenizer(
    params: dict,
    cfg: LlamaConfig,
    tokenizer,
    mm_use_im_patch_token: bool = False,
    mm_use_im_start_end: bool = False,
) -> Tuple[dict, LlamaConfig, int]:
    """Returns (params with grown embed / lm_head, the text config with the
    new vocab size, number of added tokens). The tokenizer is mutated in
    place (``add_tokens``); ``params`` is not."""
    added = 0
    if mm_use_im_patch_token:
        added += tokenizer.add_tokens([DEFAULT_IMAGE_PATCH_TOKEN], special_tokens=True)
    if mm_use_im_start_end:
        added += tokenizer.add_tokens(
            [DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN], special_tokens=True
        )
    if added <= 0:
        return params, cfg, 0

    llm = dict(params["llm"])
    llm["embed"] = _grow(llm["embed"], added, dim=0)
    if "lm_head" in llm:
        llm["lm_head"] = _grow(llm["lm_head"], added, dim=1)
    out = dict(params)
    out["llm"] = llm
    return out, dataclasses.replace(cfg, vocab_size=cfg.vocab_size + added), added
