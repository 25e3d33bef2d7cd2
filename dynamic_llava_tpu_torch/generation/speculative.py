"""Speculative (assisted) greedy decoding over the dynamic tiered cache
(counterpart of ``dynamic_llava_tpu/generation/speculative.py``).

Each round verifies ``1 + draft_k`` candidate tokens in ONE pass
(``models.dynamic.decode_speculative_step``: both tiers through
``run_layers_extend``, K2-M on the card). A small-batch decode step reads
every weight once for one token; a verify round reads them once for
``1 + draft_k``, and every accepted draft is a step saved. The output is
EXACTLY the greedy chain whatever the drafts: acceptance moves only the
round count.

Rounds run on the ``Generator``'s speculative runner
(``generation.generate.SpecRunner``: static buffers, one CUDA graph of a
round, replayed), in one of two forms:

* ``generate_speculative`` -- the host drafts. Before each round the host
  writes the drafts into the runner's static buffer and reads the round's
  result back (one host round trip a round). Any callable
  ``(context_ids, k) -> ids`` drafts: ``prompt_lookup_draft`` (the default),
  a draft model, or the oracle of a mechanical-ceiling measurement.
* ``generate_speculative_device`` -- prompt lookup on the device
  (``device_prompt_lookup`` over the runner's ``[B, ctx_cap]`` context
  grid). The JAX ``lax.while_loop`` becomes chunks of ``ROUNDS_PER_CHUNK``
  replayed rounds, chunk k+1 enqueued before chunk k's ``done`` flags are read; a
  round whose samples are all done changes nothing.

Greedy and drop mode only, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy as np
import torch

from ..multimodal.fusion import plan_batch

# verify rounds a chunk of ``generate_speculative_device``: the host reads
# the ``done`` flags once a chunk, chunk k+1 enqueued first, so a generation
# runs up to 2 R - 1 rounds after its last sample is done (each a no-op that
# still reads every weight); R = 2 keeps that to 3 while the host's read
# overlaps a whole chunk of device work
ROUNDS_PER_CHUNK = 2


def prompt_lookup_draft(context_ids, k: int, max_ngram: int = 3,
                        min_ngram: int = 1) -> List[int]:
    """Propose the k tokens that followed the most recent earlier occurrence
    of the context's trailing n-gram (longest n first, latest match first).
    A verbatim copy of the JAX package's numpy function."""
    ctx = np.asarray(context_ids)
    n = len(ctx)
    for g in range(max_ngram, min_ngram - 1, -1):
        if n < g + 1:
            continue
        pat = ctx[n - g:]
        # windows of all earlier g-grams: [n-g, g]; match latest-first,
        # excluding the trailing occurrence itself
        win = np.lib.stride_tricks.sliding_window_view(ctx, g)[: n - g]
        hits = np.nonzero((win == pat).all(axis=1))[0]
        for start in hits[::-1]:
            prop = ctx[start + g: start + g + k]
            if len(prop):
                return [int(t) for t in prop]
    return []


DraftFn = Callable[[List[int], int], List[int]]


def device_prompt_lookup(
    ctx: torch.Tensor,  # [B, C] int32 (prompt + emitted, left-aligned)
    ctx_len: torch.Tensor,  # [B] int32
    k: int,
    max_ngram: int = 3,
    min_ngram: int = 1,
) -> torch.Tensor:
    """Prompt lookup on the device: ``[B, k]`` int32 proposals, 0 where
    nothing matches (a bad draft is merely rejected). Longest n-gram first,
    latest occurrence first, one windows-against-pattern compare an n; no
    host read, so a CUDA graph can hold it."""
    b, c = ctx.shape
    dev = ctx.device
    i32 = torch.int32
    pos = torch.arange(c, dtype=i32, device=dev)
    drafts = torch.zeros((b, k), dtype=i32, device=dev)
    have = torch.zeros(b, dtype=torch.bool, device=dev)
    for g in range(max_ngram, min_ngram - 1, -1):
        lanes = torch.arange(g, dtype=i32, device=dev)
        idx = torch.clamp(ctx_len[:, None] - g + lanes[None, :], min=0)
        pat = torch.gather(ctx, 1, idx.long())  # [B, g]
        widx = torch.clamp(pos[:, None] + lanes[None, :], max=c - 1)  # [C, g]
        match = (ctx[:, widx.long()] == pat[:, None, :]).all(dim=-1)  # [B, C]
        # starts strictly before the trailing occurrence itself
        match = match & (pos[None, :] < (ctx_len - g)[:, None]) & (ctx_len >= g + 1)[:, None]
        any_m = match.any(dim=1)
        # the latest match: the first one of the reversed row
        last = (c - 1) - torch.argmax(torch.flip(match, dims=[1]).to(i32), dim=1).to(i32)
        pidx = last[:, None] + g + torch.arange(k, dtype=i32, device=dev)[None, :]
        prop = torch.gather(ctx, 1, torch.clamp(pidx, max=c - 1).long())
        prop = torch.where(pidx < ctx_len[:, None], prop, 0)
        drafts = torch.where((any_m & ~have)[:, None], prop, drafts)
        have = have | any_m
    return drafts


def _check_greedy_drop(gc) -> None:
    if gc.temperature > 0.0:
        raise ValueError("speculative decode is greedy-only (temperature 0)")
    if gc.kv_overflow != "drop":
        raise ValueError("speculative decode requires kv_overflow='drop'")


def _plan(gen, input_ids_list, pixel_values):
    return plan_batch(
        input_ids_list,
        gen.cfg.num_image_tokens if pixel_values is not None else 0,
        max_length=gen.cfg.model_max_length,
        pad_multiple=gen.gen_cfg.pad_multiple,
    )


def _fill_stats(stats: Optional[dict], rounds: int, emitted: int) -> None:
    if stats is not None:
        stats["rounds"] = rounds
        stats["emitted"] = emitted
        stats["tokens_per_round"] = round(emitted / max(rounds, 1), 3)


@torch.inference_mode()
def generate_speculative(
    gen,  # generation.generate.Generator
    input_ids_list: List[np.ndarray],
    pixel_values: Optional[np.ndarray] = None,
    draft: Union[str, DraftFn] = "prompt_lookup",
    draft_k: int = 4,
    stats: Optional[dict] = None,  # filled with rounds / emitted counters
    on_tokens=None,  # callback(sample_idx, fresh_token_ids) a round
    max_new_tokens: Optional[int] = None,  # overrides gen_cfg
) -> List[List[int]]:
    """Greedy generation through speculative rounds with drafts from the
    host; returns the token lists ``Generator.generate`` would (EOS
    included), per sample. One host round trip a round: the drafts go in,
    the accepted tokens come out."""
    gc = gen.gen_cfg
    max_new = gc.max_new_tokens if max_new_tokens is None else max_new_tokens
    _check_greedy_drop(gc)
    draft_fn: DraftFn = prompt_lookup_draft if draft == "prompt_lookup" else draft
    m = draft_k + 1
    plan = _plan(gen, input_ids_list, pixel_values)
    runner = gen.spec_runner(plan, pixel_values, max_new, m)
    state, _ = gen.prefill_into(plan, pixel_values, runner.fresh_cache())
    runner.load(state, gc.seed)
    runner.begin(plan, max_new)
    t_next = torch.argmax(state.last_logits, dim=-1).cpu().numpy()
    del state

    b = plan.batch
    prompts = [[int(t) for t in np.asarray(plan.token_ids[i][: plan.valid_len[i]])]
               for i in range(b)]
    out: List[List[int]] = [[] for _ in range(b)]
    done = np.zeros(b, bool)
    n_rounds = 0
    while not done.all():
        if n_rounds > max_new:
            # an active round emits >= 1 token; only the pre tier's clamp
            # (an undersized cache) can zero acceptance
            raise RuntimeError("speculative rounds exceeded max_new_tokens: cache "
                               "undersized for this generation?")
        drafts = np.zeros((b, m - 1), np.int32)
        for i in range(b):
            if m > 1 and not done[i]:
                d = draft_fn(prompts[i] + out[i] + [int(t_next[i])], m - 1)[: m - 1]
                drafts[i, : len(d)] = d
        rep = runner.read(runner.run_round(drafts))
        n_rounds += 1
        for i in range(b):
            if done[i]:
                continue
            fresh = [int(t) for t in rep.tokens[i, : rep.n_take[i]]]
            out[i].extend(fresh)
            if on_tokens is not None and fresh:
                on_tokens(i, fresh)
        done, t_next = rep.done, rep.next_tok
    _fill_stats(stats, n_rounds, sum(len(o) for o in out))
    return out


@torch.inference_mode()
def generate_speculative_device(
    gen,
    input_ids_list: List[np.ndarray],
    pixel_values: Optional[np.ndarray] = None,
    draft_k: int = 4,
    max_ngram: int = 3,
    min_ngram: int = 1,
    stats: Optional[dict] = None,
) -> List[List[int]]:
    """Speculative decode with prompt lookup on the device: chunks of
    ``ROUNDS_PER_CHUNK`` rounds (draft, verify, emit), the host reading
    only each chunk's ``done`` flags, and the emitted tokens once at the
    end. Same tokens as ``Generator.generate`` (greedy, EOS included).
    ``stats``: ``rounds`` counts the rounds that had an active sample (on
    the device, as the JAX loop counts them), ``rounds_run`` every round
    the device ran, the no-op ones after the last sample finished included."""
    gc = gen.gen_cfg
    _check_greedy_drop(gc)
    max_new = gc.max_new_tokens
    m = draft_k + 1
    plan = _plan(gen, input_ids_list, pixel_values)
    runner = gen.spec_runner(plan, pixel_values, max_new, m, draft=(max_ngram, min_ngram),
                             rounds=ROUNDS_PER_CHUNK)
    state, _ = gen.prefill_into(plan, pixel_values, runner.fresh_cache())
    runner.load(state, gc.seed)
    runner.begin(plan, max_new)
    del state
    first_chunk = runner.chunks_run
    # an active round emits >= 1 token: max_new rounds end every sample
    max_chunks = -(-max_new // runner.chunk) + 1
    pending = runner.run_chunk()
    for _ in range(max_chunks):
        # the next chunk is enqueued before this one's flags are read; once
        # every sample is done it changes nothing
        following = runner.run_chunk()
        if runner.read(pending).done.all():
            break
        pending = following
    else:
        raise RuntimeError("speculative rounds exceeded max_new_tokens: cache undersized "
                           "for this generation?")
    grid, n_out, rounds = runner.results()
    result = [[int(t) for t in grid[i, : n_out[i]]] for i in range(plan.batch)]
    _fill_stats(stats, rounds, int(n_out.sum()))
    if stats is not None:
        stats["rounds_run"] = (runner.chunks_run - first_chunk) * runner.chunk
    return result
