"""Continuous batching: requests admitted into a running decode batch
(counterpart of ``dynamic_llava_tpu/generation/continuous.py``).

A request joins the batch the moment a slot frees, instead of waiting for
the batch to finish. The engine owns ``slots`` decode rows at fixed cache
capacities, the static buffers of one runner:

* ``SlotDecodeRunner`` (``generation.generate``): chunks of ``decode_chunk``
  steps with in-graph stopping (EOS and each slot's limit freeze a row) and
  per-slot sampling; on a CUDA device each of its two forms (greedy, and
  sampling for the slots whose temperature is above 0) is one captured
  CUDA graph, replayed a step. The host picks the form a chunk: it wrote
  every slot's settings.
* with ``spec_k``, ``SlotSpecRunner``: chunks of ``decode_chunk`` verify
  rounds of ``spec_k + 1`` candidates, drafted by prompt lookup on the
  device over each slot's context row. Greedy only.

Admission: the queue's head is grouped by whether it has an image, the
largest power of two of it that fits the free slots is prefilled as ONE
batch (``Generator.prefill_into``, eager: K1 in CLIP and the decoder) into
rows ``[:k]`` of the one admission cache, and each row is spliced into its
slot in place (``DecodeRunner.splice_row``), with the slot's limit,
sampling settings and, under ``spec_k``, its context row. The admission
cache holds only prompts (smaller capacities than the engine's: slots past
them keep a retired request's K/V, which attention never reads) and has
``slots`` rows: one cache, made once, however many batch sizes the engine
admits (the JAX engine keeps one a batch size and never frees any).

``step`` admits, enqueues one chunk and returns the fresh tokens of the
oldest chunk not yet read, one chunk behind (at most two chunks in flight:
the runner's two host buffers). Each chunk remembers which request owned
each slot when it was enqueued, so a slot admitted later does not take
that chunk's rows. A freed slot goes back to greedy.

Greedy tokens equal a solo ``Generator.generate(pad_to=prompt_bucket)``
run of the same request on the CPU in fp32. On the card in bf16 a batch-k
admission prefill and a shared batch sum in other orders than a solo run,
so a token may differ at a near tie. Sampled rows draw from the runner's
``torch.Generator``, seeded once an engine: reproducible from the seed,
not JAX's draws. ``kv_overflow="drop"`` only, as in JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import IMAGE_TOKEN_INDEX, LlavaConfig
from ..models import dynamic
from ..multimodal.fusion import plan_batch
from ..ops.kv_cache import KVCache, TieredCache, init_tiered_cache
from ..weights import resolve_device
from .generate import (CACHE_DTYPES, GenerationConfig, Generator, SlotDecodeRunner,
                       SlotSpecRunner, runner_key)

# the prompt lookup of the speculative chunk: (max_ngram, min_ngram), the JAX defaults
SPEC_LOOKUP = (3, 1)


class Request:
    """Host-side request record."""

    def __init__(self, req_id: int, token_ids: np.ndarray,
                 pixel_values: Optional[np.ndarray], max_new: int,
                 temperature: float = 0.0, top_p: float = 1.0):
        self.id = req_id
        self.token_ids = token_ids
        self.pixel_values = pixel_values
        self.max_new = max_new
        self.temperature = temperature
        self.top_p = top_p
        self.output: List[int] = []
        self.done = False


class ContinuousEngine:
    """Slot-based continuous batching over one decode runner.

    ``prompt_bucket`` bounds (and pads) the fused prompt length;
    ``max_new_cap`` bounds any request's ``max_new_tokens``. Both size the
    cache capacities, as in the JAX engine; ``submit`` refuses requests
    past them. ``device``: where the engine runs, the card unless the
    caller names another (``"cpu"``); the params must be there."""

    def __init__(
        self,
        params,
        cfg: LlavaConfig,
        gen_cfg: GenerationConfig = GenerationConfig(),
        *,
        slots: int = 4,
        prompt_bucket: int = 128,
        max_new_cap: int = 256,
        with_images: bool = True,
        spec_k: int = 0,
        device=None,
    ):
        if gen_cfg.kv_overflow != "drop":
            raise ValueError("ContinuousEngine requires kv_overflow='drop' (a ring slot's "
                             "wrap bases are per-request state the splice does not carry)")
        if spec_k and gen_cfg.temperature != 0.0:
            # the verify round is an argmax-chain equality check
            raise ValueError("spec_k requires greedy decoding (temperature 0)")
        self.device = resolve_device(device)
        self.gen = Generator(params, cfg, gen_cfg)
        if self.gen.device.type != self.device.type:
            raise ValueError(f"the params are on {self.gen.device}, the engine runs on "
                             f"{self.device}")
        self.cfg, self.gc = cfg, gen_cfg
        self.slots = slots
        self.prompt_bucket = prompt_bucket
        self.spec_k = int(spec_k)
        m = self.spec_k + 1
        chunk = max(1, min(gen_cfg.decode_chunk, max_new_cap))
        self.chunk = chunk
        # whole chunks, so that the last chunk's overshoot has cache room
        self.max_new_cap = -(-max_new_cap // chunk) * chunk
        # capacities for the worst admissible request (JAX continuous.py:
        # 219-252): an image (the longest fused prompt) and no image prune
        # assumed for the post tier; a verify round may persist m tokens
        # past a slot's limit before the lengths roll back
        n_img = cfg.num_image_tokens if with_images else 0
        seq_len_max = prompt_bucket + (n_img - 1 if n_img else 0)
        sizes = dict(bound_output_budget=gen_cfg.bound_kv_budget, all_have_image=False,
                     bucket=gen_cfg.pad_multiple)
        pre_cap, post_cap = dynamic.gen_cache_sizes(
            cfg, seq_len_max, self.max_new_cap + (m if spec_k else 0), **sizes)
        self.pre_cap, self.post_cap = pre_cap, post_cap
        a_pre, a_post = dynamic.gen_cache_sizes(cfg, seq_len_max, 0, **sizes)
        self.admit_pre_cap = min(a_pre, pre_cap)
        self.admit_post_cap = min(a_post, post_cap)
        self.admission_cache: Optional[TieredCache] = None  # made at the first admission

        if spec_k:
            ctx_cap = seq_len_max + self.max_new_cap + m
            key = runner_key(slots, (pre_cap, post_cap), chunk=chunk)._replace(
                m=m, ctx_cap=ctx_cap, draft=SPEC_LOOKUP)
            self.runner = SlotSpecRunner(params, cfg, gen_cfg, key, self.device)
        else:
            key = runner_key(slots, (pre_cap, post_cap), stop=((gen_cfg.eos_token_id,),),
                             chunk=chunk)
            self.runner = SlotDecodeRunner(params, cfg, gen_cfg, key, self.device)
        self._temps = np.zeros(slots)  # the host's copy of the slots' temperatures
        self.admitted_batch_sizes: set = set()  # admission batch sizes this engine ran
        self._slot_req: List[Optional[int]] = [None] * slots
        self._inflight: List[tuple] = []  # enqueued chunks not yet read
        self.requests: Dict[int, Request] = {}
        self._queue: List[Request] = []
        self._next_id = 0

    # -- admission -----------------------------------------------------------

    def _fused_len(self, token_ids: np.ndarray, with_image: bool) -> int:
        n_img = int(np.sum(token_ids == IMAGE_TOKEN_INDEX)) if with_image else 0
        return len(token_ids) + n_img * (self.cfg.num_image_tokens - 1)

    def submit(self, token_ids: np.ndarray,
               pixel_values: Optional[np.ndarray] = None,
               max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None) -> int:
        """Queue a request; it enters the running batch at the next free
        slot. ``temperature`` / ``top_p`` default to the engine's
        ``GenerationConfig``: sampled and greedy requests share the batch.
        Returns the request id."""
        max_new = int(max_new_tokens or self.gc.max_new_tokens)
        if max_new > self.max_new_cap:
            raise ValueError(f"max_new {max_new} > engine cap {self.max_new_cap}")
        if self.spec_k and temperature:
            raise ValueError("spec_k engine is greedy-only")
        token_ids = np.asarray(token_ids)
        fused = self._fused_len(token_ids, pixel_values is not None)
        if max(len(token_ids), fused) > self.prompt_bucket:
            raise ValueError(f"prompt of {len(token_ids)} tokens ({fused} fused) > bucket "
                             f"{self.prompt_bucket}")
        req = Request(
            self._next_id, token_ids, pixel_values, max_new,
            temperature=(self.gc.temperature if temperature is None
                         else float(temperature)),
            top_p=self.gc.top_p if top_p is None else float(top_p),
        )
        self._next_id += 1
        self.requests[req.id] = req
        self._queue.append(req)
        return req.id

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _admission_rows(self, k: int) -> TieredCache:
        """Rows ``[:k]`` (views) of the one admission cache."""
        if self.admission_cache is None:
            with torch.inference_mode(False):
                self.admission_cache = init_tiered_cache(
                    self.cfg.text, self.cfg.sparse.sparse_layer, self.slots,
                    self.admit_pre_cap, self.admit_post_cap,
                    CACHE_DTYPES[self.gc.cache_dtype], self.device)
        return TieredCache(*(KVCache(*(None if t is None else t[:, :k] for t in tier))
                             for tier in self.admission_cache))

    def _admit_batch(self, slots: List[int], reqs: List[Request]) -> None:
        """Prefill ``reqs`` (all with or all without an image) as ONE batch
        and splice each row into its slot."""
        k = len(reqs)
        self.admitted_batch_sizes.add(k)
        has_image = reqs[0].pixel_values is not None
        plan = plan_batch(
            [r.token_ids for r in reqs],
            self.cfg.num_image_tokens if has_image else 0,
            max_length=self.cfg.model_max_length,
            pad_to=self.prompt_bucket,
        )
        pixels = None
        if has_image:
            pixels = np.stack([r.pixel_values if r.pixel_values.ndim == 3
                               else r.pixel_values[0] for r in reqs])
        runner = self.runner
        state, _ = self.gen.prefill_into(plan, pixels, self._admission_rows(k))
        prompts = (self.gen._tensor(plan.token_ids, torch.int32) if self.spec_k else None)
        for i, (slot, req) in enumerate(zip(slots, reqs)):
            runner.splice_row(state, i, slot)
            if self.spec_k:
                runner.admit(slot, req.max_new, prompts[i], int(plan.valid_len[i]))
            else:
                runner.admit(slot, req.max_new, req.temperature, req.top_p)
            self._temps[slot] = req.temperature
            self._slot_req[slot] = req.id

    def _fill_slots(self) -> None:
        free = self._free_slots()
        while free and self._queue:
            # the queue's head grouped by has-image (one prefill), the largest
            # power of two of it that fits
            has_img = self._queue[0].pixel_values is not None
            n = 0
            while (n < len(free) and n < len(self._queue)
                   and (self._queue[n].pixel_values is not None) == has_img):
                n += 1
            k = 1 << (n.bit_length() - 1)
            reqs = [self._queue.pop(0) for _ in range(k)]
            self._admit_batch(free[:k], reqs)
            free = free[k:]

    # -- the decode loop ------------------------------------------------------

    def _dispatch(self) -> None:
        """Enqueue one chunk (returns at once on a CUDA device), with the
        slots' owners as of now."""
        if self.spec_k:
            pending = self.runner.run_chunk()
        else:
            pending = self.runner.run_chunk(sampled=bool((self._temps > 0.0).any()))
        self._inflight.append((pending, list(self._slot_req)))

    def _process_oldest(self) -> Dict[int, List[int]]:
        pending, slot_req = self._inflight.pop(0)
        toks, emitted, active = self.runner.read(pending)  # the one host wait a chunk
        fresh: Dict[int, List[int]] = {}
        for slot, rid in enumerate(slot_req):
            if rid is None:
                continue
            # the caller may drop a finished request's record while a later
            # chunk still names its slot
            req = self.requests.get(rid)
            if req is None:
                continue
            new = [int(t) for t, e in zip(toks[:, slot], emitted[:, slot]) if e]
            if new:
                req.output.extend(new)
                fresh[rid] = new
            if not active[slot] and not req.done:
                req.done = True
                # free the slot only if it still belongs to this request
                if self._slot_req[slot] == rid:
                    self._slot_req[slot] = None
                    self._temps[slot] = 0.0
                    if not self.spec_k:
                        self.runner.retire(slot)
        return fresh

    @torch.inference_mode()
    def step(self) -> Dict[int, List[int]]:
        """Admit queued requests into free slots, enqueue ONE chunk, and
        return the fresh tokens (by request id) of the oldest chunk not yet
        read: one chunk behind the dispatch, so the next chunk computes
        while this one's tokens cross to the host. A request is done once
        its last chunk is read."""
        self._fill_slots()
        live = any(r is not None for r in self._slot_req)
        if live:
            self._dispatch()
        if not self._inflight:
            return {}
        # one chunk in flight while live; drain once idle
        if live and len(self._inflight) < 2:
            return {}
        return self._process_oldest()

    def idle(self) -> bool:
        return (not self._queue and not self._inflight
                and all(r is None for r in self._slot_req))

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            self.step()
            if self.idle():
                return
        raise RuntimeError("engine did not drain")

    def prewarm(self, token_ids: np.ndarray,
                pixel_values: Optional[np.ndarray] = None) -> None:
        """Drive a representative load through the engine before serving:
        (1) the admission ladder, 1, 2, 4, ... requests at once up to
        ``slots``; (2) one saturated pass, ``2 * slots`` requests of mixed
        lengths, so that full chunks meet admissions in flight, the first
        of them sampled (temperature 1, top-p 0.9) unless the engine is
        speculative. On a CUDA device this captures the runner's graphs
        (both forms) and makes the admission cache. The records of these
        requests are dropped: exactly the ids their ``submit`` calls
        returned."""
        ids = []
        chunkier = min(2 * self.chunk, self.max_new_cap)
        k = 1
        while k <= self.slots:
            ids += [self.submit(token_ids, pixel_values,
                                max_new_tokens=min(4, self.max_new_cap)) for _ in range(k)]
            self.run_until_drained()
            k *= 2
        sample = dict(temperature=1.0, top_p=0.9)
        ids += [self.submit(token_ids, pixel_values,
                            max_new_tokens=self.chunk if i % 2 else chunkier,
                            **(sample if i == 0 and not self.spec_k else {}))
                for i in range(2 * self.slots)]
        self.run_until_drained()
        for rid in ids:
            self.requests.pop(rid, None)
