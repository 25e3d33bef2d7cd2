"""Autoregressive generation (counterpart of
``dynamic_llava_tpu/generation/generate.py``).

``Generator.generate`` plans the batch on the host (``plan_batch``, the
port's own copy in ``multimodal.fusion``), runs ``dynamic.prefill``, then
decodes in chunks of ``decode_chunk`` steps through a ``DecodeRunner``, the
counterpart of the JAX ``_decode_chunk_fn`` (a ``lax.scan`` of sampling and
``decode_step`` compiled into one device program, the state donated):

* The runner owns static buffers for everything a step reads and writes:
  both tiers' KV cache and lengths, ``next_pos``, ``last_logits``, the ring
  bases, a ``[chunk, B]`` int32 token buffer and a device-side step index.
  ``prefill_from_plan`` writes the prompt's K/V into that cache (zeroed
  first, so the state equals a fresh ``make_gen_cache``'s). A step is
  ``_sample`` -> ``dynamic.decode_step`` (K/V written in place) -> the
  step's fresh lengths, ``next_pos`` and ``last_logits`` copied back into
  the static buffers -> the token written into the chunk buffer at the step
  index -> the index advanced: device work only, no host read.
* On a CUDA tensor the step runs eagerly once (that builds the kernel
  library, sets the kernels' one-time attributes, makes the device's ticket
  buffer and initialises cuBLAS), is then captured as ONE CUDA graph, and
  the graph is replayed for every later step, of this call and of every
  later call with the same ``RunnerKey`` (the counterpart of the JAX
  trace cache). A ``Generator`` keeps one runner: a call with another key
  frees it (its KV cache, graph and pool) and makes a new one. A capture or
  replay that fails raises: there is no eager fallback.
* On a CPU tensor the same runner runs every step eagerly: same buffers,
  same order of operations.
* Greedy decoding and temperature / top-p sampling both take the graph; the
  runner's ``torch.Generator`` is registered with it
  (``CUDAGraph.register_generator_state``), so one seed gives the same
  tokens from the graph as from eager steps.
* Chunks are pipelined as in the JAX ``generate``: chunk k+1 is enqueued
  before chunk k's tokens are read (a non-blocking copy into pinned host
  memory and an event), so the host's EOS / stopping / streaming work
  overlaps the device's. A speculative chunk past the stop is discarded and
  the returned lists are cut exactly at the stop point.

Multi-round chat (``ChatSession``, the counterpart of the JAX one) decodes
through a ``StopDecodeRunner``, the counterpart of the JAX
``_decode_chunk_stop_fn``: the same runner with in-graph stopping. Its
static buffers add ``active``, a rolling ``[B, K]`` history of the last
tokens, the emitted count and the limit; the stop sequences are a device
constant made before the capture and part of its ``RunnerKey``. A step
freezes a sample (``decode_step(active=)``) once its history ends with a
stop sequence or its count reaches the limit, so the live cache holds
exactly the emitted tokens however far a chunk runs past the stop; it
records the token and whether it was emitted, and the tokens, the emitted
flags and the end-of-chunk ``active`` reach the host in one pinned copy a
chunk. A session owns its runner (its KV cache and graph), apart from the
``Generator``'s: a ``generate`` call between two rounds leaves it alone.

Speculative decoding (``generate_speculative``, ``generate_speculative_device``;
``generation/speculative.py``) runs on a ``SpecRunner``: the same runner
with a verify round of ``m`` candidates (``dynamic.decode_speculative_step``)
as its step, and the drafts, the emitted tokens and the context they are
drafted from in static buffers. It takes the ``Generator``'s one runner slot:
a speculative key replaces a plain one and the other way round.

Continuous batching (``generation/continuous.py``) runs on runners whose
rows are slots that requests enter and leave between chunks, owned by the
engine: ``SlotDecodeRunner`` (the stopping runner with per-slot limits and
per-slot temperature / top-p, ``_sample_per_slot``; a greedy and a sampling
graph on the same buffers, the host picking one a chunk) and
``SlotSpecRunner`` (verify rounds with prompt lookup over each slot's
context row). A request enters by ``DecodeRunner.splice_row`` and the
runner's ``admit``, written a slot at a time between chunks.

Every kernel wrapper counts its host calls in ``<wrapper>.launches``: an
eager launch, or the one launch a capture records into the graph. A
graph's replays launch on the device without a host call, so the launches
on the card are counted by ``kernels.counts``: a runner keeps the launches
its capture recorded (``graph_launches``) and its replays (``replays``),
and each replay (``DecodeRunner.replay``) counts the capture's launches
once more.

Lean-memory options, as in the JAX package: ``cache_dtype`` stores the KV
cache in bf16 / fp32, scaled int8 (``"int8"``) or fp8
(``"float8_e4m3fn"``); ``kv_overflow="ring"`` with ``kv_window`` bounds
both tiers for long generations (each new token past the budget evicts the
oldest decode entry).
"""

from __future__ import annotations

import contextlib
import gc as pygc  # `gc` names the generation configs here
import time
from collections import Counter
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import LlavaConfig
from ..kernels import counts
from ..models import dynamic
from ..multimodal.fusion import FusionPlan, plan_batch
from ..ops.kv_cache import TieredCache, init_tiered_cache, splice_tiered_slot
from ..ops.quant import q4_mlp_enabled
from . import speculative


class GenerationConfig(NamedTuple):
    """Same fields and defaults as the JAX ``GenerationConfig``.
    ``cache_dtype`` is one of ``CACHE_DTYPES``; ``kv_overflow`` is ``"drop"``
    (force-drop once the post tier's budget fills) or ``"ring"`` (evict the
    oldest decode entry; incompatible with a sliding-window model);
    ``kv_window`` caps the decode headroom (the ring's window size)."""

    max_new_tokens: int = 128
    temperature: float = 0.0
    top_p: float = 1.0
    eos_token_id: int = 2
    cache_dtype: str = "bfloat16"
    bound_kv_budget: bool = True
    decode_chunk: int = 32
    pad_multiple: int = 64
    seed: int = 0
    kv_overflow: str = "drop"
    kv_window: Optional[int] = None


CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn}

def _sample(generator: Optional[torch.Generator], logits: torch.Tensor,
            temperature: float, top_p: float) -> torch.Tensor:
    """Greedy (first maximum, like ``jnp.argmax``) at temperature 0; else
    temperature / top-p sampling from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _sample_per_slot(generator: Optional[torch.Generator], logits: torch.Tensor,
                     temps: torch.Tensor, top_ps: torch.Tensor) -> torch.Tensor:
    """Per-row temperature / top-p (the JAX ``_sample_per_slot``; the
    continuous engine's slots carry their requests' settings): rows at
    temperature 0 take the argmax (the first maximum), the others a draw
    from ``generator`` over their nucleus. The JAX function sorts only when
    some row has ``top_p < 1`` (a ``lax.cond``); here the caller picks this
    function or a plain argmax on the host, which knows every row's
    settings. A row whose fp32 cumulative sum stays below its ``top_p`` at
    all V entries (``top_p = 1`` can) has no cutoff: JAX gathers NaN at
    index V there and masks nothing, ``torch.gather`` would fault, so the
    index is clamped and V means no cutoff."""
    greedy = torch.argmax(logits, dim=-1)
    lg = logits.float() / torch.clamp(temps, min=1e-6)[:, None]
    v = lg.shape[-1]
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_lg, dim=-1), dim=-1)
    cutoff_idx = torch.sum(cum < top_ps[:, None], dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_lg, -1, torch.clamp(cutoff_idx, max=v - 1))
    cutoff = torch.where(cutoff_idx >= v, float("-inf"), cutoff)
    lg = torch.where(lg < cutoff, float("-inf"), lg)
    samp = torch.multinomial(torch.softmax(lg, dim=-1), 1, generator=generator)[:, 0]
    return torch.where(temps > 0.0, samp, greedy)


@contextlib.contextmanager
def capturing(graph):
    """``torch.cuda.graph(graph)`` with Python's cyclic garbage collector
    paused. A collection inside the capture can free the CUDA objects of
    dead reference cycles (a graph, an event, a finished trace's buffers),
    which a capturing stream does not permit: the capture is invalidated
    and the next launch in it fails (cuBLAS did, ROADMAP C24).
    ``torch.cuda.graph`` no longer collects at its entry; paused, the
    collection comes after the capture."""
    enabled = pygc.isenabled()
    pygc.disable()
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        if enabled:
            pygc.enable()


def decode_chunk_len(gc: GenerationConfig) -> int:
    """Decode steps a chunk (the host syncs once a chunk)."""
    return max(1, min(gc.decode_chunk, gc.max_new_tokens))


class RunnerKey(NamedTuple):
    """What a captured decode step depends on beyond the ``Generator``'s
    params and config (sampling, cache dtype and overflow policy are fixed
    by its ``GenerationConfig``)."""

    batch: int
    pre_len: int  # tier capacities
    post_len: int
    q4_mlp: bool  # DYNAMIC_LLAVA_Q4_MLP, read at every dispatch: a graph freezes it
    stop: Tuple[Tuple[int, ...], ...] = ()  # a StopDecodeRunner's stop sequences
    chunk: int = 0  # steps a chunk; 0: ``decode_chunk_len`` of the config
    # a SpecRunner's: candidates a round (0: not speculative), the context
    # grid's width, and its drafts: () from the host, (max_ngram, min_ngram)
    # prompt lookup on the device
    m: int = 0
    ctx_cap: int = 0
    draft: Tuple[int, ...] = ()


def runner_key(batch: int, capacities: Tuple[int, int], stop=(), chunk: int = 0
               ) -> RunnerKey:
    return RunnerKey(batch, *capacities, q4_mlp_enabled(), tuple(stop), chunk)


class PendingChunk:
    """A chunk's tokens on their way to the host: the ``index``-th chunk of
    ``runner``, in one of its two host buffers."""

    def __init__(self, runner: "DecodeRunner", index: int, host: torch.Tensor,
                 event: Optional[torch.cuda.Event]):
        self.runner, self.index, self.host, self.event = runner, index, host, event

    def tokens(self) -> np.ndarray:
        """Waits for the chunk; ``[chunk, B]`` int32 token ids (a
        ``StopDecodeRunner`` appends rows: ``StopDecodeRunner.read``)."""
        if self.runner.chunks_run > self.index + 2:
            raise RuntimeError("PendingChunk.tokens: the chunk after next has reused this "
                               "chunk's host buffer; read a chunk before enqueueing it")
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().copy()


class DecodeRunner:
    """Decode steps on static buffers, eager or replayed from a CUDA graph
    (see the module docstring). ``load`` takes a prefilled state,
    ``run_chunk`` enqueues ``chunk`` steps and the copy of their tokens to
    the host."""

    def __init__(self, params, cfg: LlavaConfig, gc: GenerationConfig, key: RunnerKey,
                 device, state: Optional[dynamic.GenState] = None):
        """``state``: another runner's static buffers (same key but for the
        stop sequences and the chunk) to adopt instead of making new ones."""
        self.params, self.cfg, self.key = params, cfg, key
        self.temperature, self.top_p = gc.temperature, gc.top_p
        self.kv_overflow = gc.kv_overflow
        self.chunk = key.chunk or decode_chunk_len(gc)
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        b, ring = key.batch, gc.kv_overflow == "ring"
        # normal (not inference) tensors: written inside and outside inference mode
        with torch.inference_mode(False):
            i32 = dict(dtype=torch.int32, device=self.device)
            self.state = state if state is not None else dynamic.GenState(
                cache=init_tiered_cache(cfg.text, cfg.sparse.sparse_layer, b, key.pre_len,
                                        key.post_len, CACHE_DTYPES[gc.cache_dtype],
                                        self.device),
                next_pos=torch.zeros(b, **i32),
                last_logits=torch.zeros(b, cfg.text.vocab_size, dtype=torch.float32,
                                        device=self.device),
                ring_base=torch.zeros(b, **i32) if ring else None,
                ring_base_pre=torch.zeros(b, **i32) if ring else None,
            )
            # what a chunk copies to the host: its tokens (a StopDecodeRunner
            # adds rows), token j of the chunk in row j
            self.out = torch.zeros(self._out_rows(), b, **i32)
            self.toks = self.out[:self.chunk]
            self.step_index = torch.zeros(1, dtype=torch.long, device=self.device)
        self.generator = (None if gc.temperature <= 0.0
                          else torch.Generator(device=self.device))
        # two host buffers: chunk k's is read while chunk k+1's copy is in flight
        self.host = [torch.zeros(self.out.shape, dtype=torch.int32, pin_memory=self.graphed)
                     for _ in range(2)]
        self.chunks_run = 0
        self.eager_steps = 0  # steps run eagerly on a CUDA device (one before each capture)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.graph_launches: Counter = Counter()  # kernel launches recorded in the capture
        self.replays = 0  # replays of this runner's graphs
        self.capture_ms: Optional[float] = None

    def _out_rows(self) -> int:
        return self.chunk

    def _fresh_outputs(self, state: dynamic.GenState):
        """(``state``'s tensor, static buffer) pairs of what a step returns
        as new tensors."""
        st = self.state
        return [(state.cache.pre.length, st.cache.pre.length),
                (state.cache.post.length, st.cache.post.length),
                (state.next_pos, st.next_pos), (state.last_logits, st.last_logits)]

    def fresh_cache(self) -> TieredCache:
        """The runner's KV cache, zeroed: what ``make_gen_cache`` would make."""
        for tier in self.state.cache:
            for t in tier:
                if t is not None:
                    (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).zero_()
        return self.state.cache

    def load(self, state: dynamic.GenState, seed: int) -> None:
        """Take ``state`` (prefilled into ``fresh_cache``) as the step's
        state; the next chunk writes its tokens from row 0."""
        st = self.state
        for got, own in zip(state.cache, st.cache):
            if got.k is not own.k or got.v is not own.v:
                raise ValueError("DecodeRunner.load: the state's KV cache is not the "
                                 "runner's (prefill into fresh_cache())")
        pairs = self._fresh_outputs(state)
        if st.ring_base is not None:
            pairs += [(state.ring_base, st.ring_base),
                      (state.ring_base_pre, st.ring_base_pre)]
        for src, dst in pairs:
            if src is None or src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"DecodeRunner.load: {None if src is None else (src.shape, src.dtype)} "
                    f"does not fit the static buffer {(dst.shape, dst.dtype)}")
            dst.copy_(src)
        self.step_index.zero_()
        if self.generator is not None:
            self.generator.manual_seed(seed)

    def splice_row(self, state: dynamic.GenState, row: int, slot: int) -> None:
        """Copy row ``row`` of a prefilled ``state`` (another cache's, at most
        this one's capacities) into batch slot ``slot`` of the static
        buffers, in place: K/V, lengths, ``next_pos`` and ``last_logits``."""
        st = self.state
        splice_tiered_slot(st.cache, state.cache, slot, row)
        st.next_pos[slot].copy_(state.next_pos[row])
        st.last_logits[slot].copy_(state.last_logits[row])

    def _next_token(self) -> torch.Tensor:
        """The step's input token ``[B]``, from ``last_logits``."""
        return _sample(self.generator, self.state.last_logits, self.temperature, self.top_p)

    def _draws(self) -> bool:
        """Whether a step draws from ``generator`` (its capture registers it)."""
        return self.generator is not None

    def step(self) -> None:
        """One decode step on the static buffers (device work only)."""
        tok = self._next_token()
        new = dynamic.decode_step(self.params, self.cfg, tok, self.state,
                                  kv_overflow=self.kv_overflow)
        for src, dst in self._fresh_outputs(new):
            dst.copy_(src)
        self.toks.index_copy_(0, self.step_index, tok.to(torch.int32)[None])
        self.step_index.add_(1).remainder_(self.chunk)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        if self._draws():
            graph.register_generator_state(self.generator)
        t0 = time.perf_counter()
        with capturing(graph), counts.capture() as launches:
            self.step()
        torch.cuda.synchronize()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph, self.graph_launches = graph, launches

    def replay(self) -> None:
        """One replay of the captured step; the launches its capture
        recorded count once more on the card (``kernels.counts``)."""
        self.graph.replay()
        self.replays += 1
        counts.replayed(self.graph_launches)

    def run_chunk(self) -> PendingChunk:
        """Enqueue ``chunk`` steps and the copy of their tokens to the host;
        returns at once on a CUDA device. The chunk's host buffer is reused
        by the chunk after next: read a chunk before that one is enqueued."""
        for _ in range(self.chunk):
            if not self.graphed:
                self.step()
                continue
            if self.graph is None:
                self.step()  # eager first: one-time set-up happens outside the capture
                self.eager_steps += 1
                self._capture()
                continue
            self.replay()
        index = self.chunks_run
        host = self.host[index % 2]
        self.chunks_run += 1
        host.copy_(self.out, non_blocking=self.graphed)
        event = None
        if self.graphed:
            event = torch.cuda.Event()
            event.record()
        return PendingChunk(self, index, host, event)


class StopDecodeRunner(DecodeRunner):
    """A ``DecodeRunner`` with in-graph stopping (the JAX
    ``_decode_chunk_stop_fn`` without its per-slot sampling and packed-rng
    forms): its key's ``stop`` sequences (EOS is a sequence of one) end a
    sample when its last emitted tokens equal one of them, and the limit
    ends it after ``limit`` tokens. A stopped sample is frozen
    (``decode_step(active=)``): its lengths, ``next_pos``, ``last_logits``
    and history stay as they were. A chunk's host copy holds ``[2 * chunk +
    1, B]`` int32 rows: the tokens, whether each was emitted (produced while
    the sample was active; the stopping token itself is), and ``active`` at
    the chunk's end (``read``)."""

    def __init__(self, params, cfg: LlavaConfig, gc: GenerationConfig, key: RunnerKey,
                 device, state: Optional[dynamic.GenState] = None):
        if not key.stop:
            raise ValueError("StopDecodeRunner: the key names no stop sequence")
        super().__init__(params, cfg, gc, key, device, state)
        b = key.batch
        k_hist = max(len(seq) for seq in key.stop)
        # stop sequences right-aligned in a [n_stop, K] matrix, the padding
        # before each marked by position (the JAX matrix marks it by a
        # negative id, so a negative stop id, such as an EOS of -1, matched
        # at once there; here it never matches, as no token is negative)
        stop_mat = np.zeros((len(key.stop), k_hist), np.int32)
        stop_pad = np.ones((len(key.stop), k_hist), bool)
        for i, seq in enumerate(key.stop):
            stop_mat[i, k_hist - len(seq):] = seq
            stop_pad[i, k_hist - len(seq):] = False
        with torch.inference_mode(False):
            i32 = dict(dtype=torch.int32, device=self.device)
            # device constants, made before any capture
            self.stop_mat = torch.from_numpy(stop_mat).to(self.device)
            self.stop_pad = torch.from_numpy(stop_pad).to(self.device)
            self.emitted = self.out[self.chunk:2 * self.chunk]
            self.active = torch.zeros(b, dtype=torch.bool, device=self.device)
            self.hist = torch.full((b, k_hist), -1, **i32)
            self.n_emit = torch.zeros(b, **i32)
            self.limit = torch.zeros(b, **i32)

    def _out_rows(self) -> int:
        return 2 * self.chunk + 1

    def begin(self, limit: int, seed: int) -> None:
        """Start a round: every sample active, an empty history, nothing
        emitted, at most ``limit`` tokens; the next chunk writes from row 0."""
        self.active.fill_(True)
        self.hist.fill_(-1)
        self.n_emit.zero_()
        self.limit.fill_(limit)
        self.step_index.zero_()
        if self.generator is not None:
            self.generator.manual_seed(seed)

    def step(self) -> None:
        """One decode step with the stop test on the static buffers (device
        work only)."""
        i32 = torch.int32
        active = self.active
        tok = self._next_token()
        new = dynamic.decode_step(self.params, self.cfg, tok, self.state, active=active,
                                  kv_overflow=self.kv_overflow)
        for src, dst in self._fresh_outputs(new):
            dst.copy_(src)
        hist = torch.cat([self.hist[:, 1:], tok.to(i32)[:, None]], dim=1)
        # [B, n_stop, K]: every position matches or is padding
        match = (hist[:, None, :] == self.stop_mat[None]) | self.stop_pad[None]
        stop_hit = match.all(dim=-1).any(dim=-1)
        n_emit = self.n_emit + active.to(i32)
        still = active & ~stop_hit & (n_emit < self.limit)
        self.toks.index_copy_(0, self.step_index, tok.to(i32)[None])
        self.emitted.index_copy_(0, self.step_index, active.to(i32)[None])
        self.out[2 * self.chunk].copy_(still)  # after a chunk's last step: its end
        # frozen samples keep their history (their token is not theirs)
        self.hist.copy_(torch.where(active[:, None], hist, self.hist))
        self.n_emit.copy_(n_emit)
        self.active.copy_(still)
        self.step_index.add_(1).remainder_(self.chunk)

    def read(self, pending: PendingChunk):
        """``(tokens [chunk, B], emitted [chunk, B] bool, active [B] bool)``
        of a chunk, waiting for it."""
        rows = pending.tokens()
        c = self.chunk
        return rows[:c], rows[c:2 * c].astype(bool), rows[2 * c].astype(bool)


class SpecReport(NamedTuple):
    """A speculative round's result on the host (the last round of a chunk)."""

    tokens: np.ndarray  # [B, M] the round's candidates
    n_take: np.ndarray  # [B] how many of them were emitted
    next_tok: np.ndarray  # [B] the token after the accepted prefix
    done: np.ndarray  # [B] bool, after the round


class SpecRunner(DecodeRunner):
    """Speculative verify rounds on static buffers, eager or replayed from
    a CUDA graph (the counterpart of the JAX ``Generator._spec_fn``, of the
    round of ``_spec_chunk_fn`` and of the body of the device loop in
    ``speculative.py``). Its key adds to ``RunnerKey`` the candidates a
    round ``m``, the context grid's width ``ctx_cap`` and the draft source;
    ``chunk`` counts rounds.

    A round: the committed token (argmax of ``last_logits``) and ``m - 1``
    drafts, read from the static ``drafts`` buffer the host wrote
    (``run_round``) or proposed by ``device_prompt_lookup`` over the
    context grid with the committed token appended; then
    ``dynamic.decode_speculative_step`` with ``active = ~done``; then the
    emit: the accepted tokens, cut at the limit, scattered into the output
    and context grids. Each grid has one spare column past ``ctx_cap`` that
    the lanes not emitted write to (PyTorch has no dropping scatter). A
    sample is done after it emits EOS or reaches the limit; a round whose
    samples are all done changes nothing. ``rounds`` counts, on the device,
    the rounds that had an active sample. The host copy of a chunk is the
    last round's ``[M + 3, B]`` report (``read``); the emitted tokens come
    back at the end (``results``)."""

    def __init__(self, params, cfg: LlavaConfig, gc: GenerationConfig, key: RunnerKey,
                 device):
        if key.m < 1 or key.ctx_cap < 1:
            raise ValueError(f"SpecRunner: the key names no speculative round ({key})")
        super().__init__(params, cfg, gc, key, device)
        self.eos = gc.eos_token_id
        b, m, cap = key.batch, key.m, key.ctx_cap
        with torch.inference_mode(False):
            i32 = dict(dtype=torch.int32, device=self.device)
            self.ctx = torch.zeros(b, cap + 1, **i32)  # prompt + emitted, spare column
            self.grid = torch.zeros(b, cap + 1, **i32)  # emitted tokens, spare column
            self.ctx_len = torch.zeros(b, **i32)
            self.n_out = torch.zeros(b, **i32)
            self.limit = torch.zeros(b, **i32)
            self.done = torch.zeros(b, dtype=torch.bool, device=self.device)
            self.rounds = torch.zeros(1, **i32)
            self.drafts = torch.zeros(b, m - 1, **i32)
            self.lanes = torch.arange(m, **i32)[None]  # a device constant
        self.host_drafts = torch.zeros((b, m - 1), dtype=torch.int32, pin_memory=self.graphed)

    def _out_rows(self) -> int:
        return self.key.m + 3

    def begin(self, plan: FusionPlan, limit: int) -> None:
        """Start a generation of at most ``limit`` tokens a sample: the
        context grid holds the plan's prompts, nothing is emitted or done."""
        s = plan.seq_len
        if s + limit + self.key.m > self.key.ctx_cap:
            raise ValueError(f"SpecRunner.begin: {s} prompt slots and {limit} new tokens "
                             f"pass the context grid of {self.key.ctx_cap}")
        self.ctx.zero_()
        self.ctx[:, :s].copy_(torch.from_numpy(np.asarray(plan.token_ids, np.int32)))
        self.ctx_len.copy_(torch.from_numpy(np.asarray(plan.valid_len, np.int32)))
        for t in (self.grid, self.n_out, self.done, self.rounds):
            t.zero_()
        self.limit.fill_(limit)
        self.step_index.zero_()

    def _round(self):
        """One speculative round on the static buffers (device work only):
        ``(tokens [B, M] int32, emit [B, M] bool, n_take [B], next_tok [B])``."""
        key, st = self.key, self.state
        m, cap = key.m, key.ctx_cap
        t_next = torch.argmax(st.last_logits, dim=-1).to(torch.int32)
        if m > 1 and key.draft:
            # draft from the context WITH the committed token appended (a
            # scratch copy: the grid takes only emitted tokens)
            ctx = self.ctx[:, :cap].clone()
            ctx.scatter_(1, torch.clamp(self.ctx_len, max=cap - 1).long()[:, None],
                         t_next[:, None])
            drafts = speculative.device_prompt_lookup(ctx, self.ctx_len + 1, m - 1, *key.draft)
        else:
            drafts = self.drafts  # the host's (run_round); [B, 0] at m = 1
        tokens = torch.cat([t_next[:, None], drafts], dim=1)
        active = ~self.done
        new, n_acc, next_tok = dynamic.decode_speculative_step(
            self.params, self.cfg, tokens, st, self.eos, active=active)
        for src, dst in self._fresh_outputs(new):
            dst.copy_(src)
        n_take = torch.minimum(n_acc, self.limit - self.n_out)
        emit = self.lanes < n_take[:, None]
        if self.grid is not None:
            self.grid.scatter_(1, torch.where(emit, self.n_out[:, None] + self.lanes,
                                              cap).long(), tokens)
        self.ctx.scatter_(1, torch.where(emit, self.ctx_len[:, None] + self.lanes, cap).long(),
                          tokens)
        self.n_out.add_(n_take)
        self.ctx_len.add_(n_take)
        self.rounds.add_(active.any().to(torch.int32))
        eos_hit = ((tokens == self.eos) & emit).any(dim=1)
        self.done.copy_(self.done | eos_hit | (self.n_out >= self.limit))
        return tokens, emit, n_take, next_tok

    def step(self) -> None:
        """One speculative round and its report (device work only)."""
        tokens, _, n_take, next_tok = self._round()
        m = self.key.m
        rep = self.out
        rep[:m].copy_(tokens.T)
        rep[m].copy_(n_take)
        rep[m + 1].copy_(next_tok)
        rep[m + 2].copy_(self.done)

    def run_round(self, drafts: np.ndarray) -> PendingChunk:
        """Write the host's ``[B, m - 1]`` drafts into the static buffer and
        enqueue one round (a runner whose chunk is one round)."""
        self.host_drafts.copy_(torch.from_numpy(np.asarray(drafts, np.int32)))
        self.drafts.copy_(self.host_drafts, non_blocking=self.graphed)
        return self.run_chunk()

    def read(self, pending: PendingChunk) -> SpecReport:
        """The report of a chunk's last round, waiting for it."""
        rows = pending.tokens()
        m = self.key.m
        return SpecReport(tokens=rows[:m].T, n_take=rows[m], next_tok=rows[m + 1],
                          done=rows[m + 2].astype(bool))

    def results(self):
        """``(grid [B, ctx_cap] tokens, n_out [B], rounds)`` after the work
        enqueued so far (synchronises)."""
        cap = self.key.ctx_cap
        return (self.grid[:, :cap].cpu().numpy(), self.n_out.cpu().numpy(),
                int(self.rounds.cpu()[0]))


class SlotDecodeRunner(StopDecodeRunner):
    """The continuous engine's chunk (the JAX ``_decode_chunk_stop_fn`` with
    ``per_slot_sampling`` and ``pack_results``): a ``StopDecodeRunner``
    whose rows are slots that requests enter and leave between chunks. Each
    slot has its own ``active``, history, emitted count and limit, and its
    own ``temps`` / ``top_ps``, written a slot at a time (``admit``,
    ``retire``), never all at once. The host copy of a chunk is the packed
    ``[2 * chunk + 1, B]`` rows of ``read``.

    Two step forms on the same buffers, each captured once on a CUDA
    device: greedy (argmax) and per-slot sampling (``_sample_per_slot``,
    its draws from ``generator``, seeded once for the runner). The host
    picks one a chunk (``run_chunk(sampled)``): it wrote every slot's
    settings, so it knows whether any row samples."""

    def __init__(self, params, cfg: LlavaConfig, gc: GenerationConfig, key: RunnerKey,
                 device):
        super().__init__(params, cfg, gc, key, device)
        with torch.inference_mode(False):
            self.temps = torch.zeros(key.batch, dtype=torch.float32, device=self.device)
            self.top_ps = torch.ones(key.batch, dtype=torch.float32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(gc.seed)
        self.sampled = False  # the form of the chunk being run
        self.graphs = {}  # form -> its CUDA graph
        self.captures_ms = {}  # form -> its capture's ms
        self.forms_launches = {}  # form -> the launches its capture recorded

    def admit(self, slot: int, limit: int, temperature: float, top_p: float) -> None:
        """Start slot ``slot``'s request (its state spliced in by
        ``splice_row``): active, an empty history, nothing emitted, at most
        ``limit`` tokens, its sampling settings."""
        self.active[slot] = True
        self.hist[slot] = -1
        self.n_emit[slot] = 0
        self.limit[slot] = limit
        self.temps[slot] = temperature
        self.top_ps[slot] = top_p

    def retire(self, slot: int) -> None:
        """A freed slot goes back to greedy, so that a retired sampled
        request does not keep the sampling form running."""
        self.temps[slot] = 0.0
        self.top_ps[slot] = 1.0

    def _next_token(self) -> torch.Tensor:
        logits = self.state.last_logits
        if not self.sampled:
            return torch.argmax(logits, dim=-1)
        return _sample_per_slot(self.generator, logits, self.temps, self.top_ps)

    def _draws(self) -> bool:
        return self.sampled

    def run_chunk(self, sampled: bool = False) -> PendingChunk:
        """``DecodeRunner.run_chunk`` in the greedy or the sampling form."""
        self.sampled = bool(sampled)
        self.graph = self.graphs.get(self.sampled)
        self.graph_launches = self.forms_launches.get(self.sampled, Counter())
        pending = super().run_chunk()
        if self.graph is not None and self.sampled not in self.graphs:
            self.graphs[self.sampled] = self.graph
            self.captures_ms[self.sampled] = self.capture_ms
            self.forms_launches[self.sampled] = self.graph_launches
        return pending


class SlotSpecRunner(SpecRunner):
    """The continuous engine's speculative chunk (the JAX ``_spec_chunk_fn``):
    ``chunk`` verify rounds a dispatch over slots that requests enter and
    leave between chunks, each round ``SpecRunner``'s (the committed token
    and ``m - 1`` drafts by ``device_prompt_lookup`` over the slot's context
    row, ``decode_speculative_step`` with ``active = ~done``, the emit cut at
    the slot's limit, EOS the only stop). Greedy only. The host copy of a
    chunk is the JAX packed layout ``[2 * R * M + 1, B]``: round r's M
    tokens in rows ``r * M ...``, then their emit flags, then ``active`` at
    the chunk's end (``read``). ``admit`` writes one slot's limit, flags and
    context row (its prompt, the spare column kept)."""

    def __init__(self, params, cfg: LlavaConfig, gc: GenerationConfig, key: RunnerKey,
                 device):
        if not key.draft:
            raise ValueError("SlotSpecRunner drafts on the device: the key names no lookup")
        super().__init__(params, cfg, gc, key, device)
        self.grid = None  # the emitted tokens reach the host a chunk, in the packed rows
        r, m, b = self.chunk, key.m, key.batch
        self.tok_rows = self.out[:r * m].view(r, m, b)
        self.emit_rows = self.out[r * m:2 * r * m].view(r, m, b)

    def _out_rows(self) -> int:
        return 2 * self.chunk * self.key.m + 1

    def admit(self, slot: int, limit: int, prompt: torch.Tensor, valid_len: int) -> None:
        """Start slot ``slot``'s request (its state spliced in by
        ``splice_row``): not done, nothing emitted, at most ``limit`` tokens,
        its context row the prompt's ``[S]`` token ids (on the device) with
        ``valid_len`` of them live."""
        if prompt.shape[0] + limit + self.key.m > self.key.ctx_cap:
            raise ValueError(f"SlotSpecRunner.admit: {prompt.shape[0]} prompt slots and "
                             f"{limit} new tokens pass the context grid of {self.key.ctx_cap}")
        self.done[slot] = False
        self.n_out[slot] = 0
        self.limit[slot] = limit
        self.ctx[slot].zero_()
        self.ctx[slot, :prompt.shape[0]].copy_(prompt)
        self.ctx_len[slot] = valid_len

    def step(self) -> None:
        """One round; its tokens and emit flags go to the chunk's rows of
        the round (device work only)."""
        tokens, emit, _, _ = self._round()
        idx = self.step_index
        self.tok_rows.index_copy_(0, idx, tokens.T[None])
        self.emit_rows.index_copy_(0, idx, emit.T.to(torch.int32)[None])
        self.out[-1].copy_(~self.done)
        self.step_index.add_(1).remainder_(self.chunk)

    def read(self, pending: PendingChunk):
        """``(tokens [R * M, B], emitted [R * M, B] bool, active [B] bool)``
        of a chunk, waiting for it."""
        rows = pending.tokens()
        n = self.chunk * self.key.m
        return rows[:n], rows[n:2 * n].astype(bool), rows[2 * n].astype(bool)


class Generator:
    """Generation harness for fixed params, model config and generation
    config. ``params`` is the port's param tree (``weights``), all on one
    device; inputs are moved there. A state returned by
    ``prefill_from_plan`` lives in the buffers of the ``Generator``'s one
    decode runner: the next prefill or ``generate`` overwrites it."""

    def __init__(self, params, cfg: LlavaConfig,
                 gen_cfg: GenerationConfig = GenerationConfig()):
        if gen_cfg.kv_overflow not in ("drop", "ring"):
            raise ValueError(
                f"kv_overflow must be 'drop' or 'ring', got {gen_cfg.kv_overflow!r}")
        if gen_cfg.cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"cache_dtype must be one of {sorted(CACHE_DTYPES)}, "
                             f"got {gen_cfg.cache_dtype!r}")
        self.params = params
        self.cfg = cfg
        self.gen_cfg = gen_cfg
        # the final norm is a plain tensor; the embed may be a quantized dict
        self.device = params["llm"]["final_ln"].device
        self.decode_runner: Optional[DecodeRunner] = None

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    @staticmethod
    def _all_have_image(plan: FusionPlan, pixel_values) -> bool:
        return pixel_values is not None and bool(np.asarray(plan.spans.has_image).all())

    def cache_sizes(self, plan: FusionPlan, pixel_values,
                    max_new_tokens: int) -> Tuple[int, int]:
        """The tier capacities of ``plan`` with room for ``max_new_tokens``."""
        gc = self.gen_cfg
        return dynamic.gen_cache_sizes(
            self.cfg, plan.seq_len, max_new_tokens,
            bound_output_budget=gc.bound_kv_budget,
            all_have_image=self._all_have_image(plan, pixel_values),
            bucket=gc.pad_multiple,
            decode_window=gc.kv_window,
            ring=gc.kv_overflow == "ring",
        )

    def _keep_runner(self, key: RunnerKey, kind) -> DecodeRunner:
        """The kept runner if its key is ``key``, else a new ``kind`` that
        replaces it."""
        if self.decode_runner is None or self.decode_runner.key != key:
            self.decode_runner = None  # the old cache and graph go before the new ones come
            self.decode_runner = kind(self.params, self.cfg, self.gen_cfg, key, self.device)
        return self.decode_runner

    def runner(self, plan: FusionPlan, pixel_values, max_new_tokens: int,
               chunk: int = 0) -> DecodeRunner:
        """The runner for this batch shape, the tier capacities of
        ``max_new_tokens``, ``chunk`` steps a chunk (0: ``decode_chunk_len``
        of the config) and the current dispatch settings: the one kept if
        its key is the same, else a new one that replaces it."""
        key = runner_key(plan.batch, self.cache_sizes(plan, pixel_values, max_new_tokens),
                         chunk=chunk)
        return self._keep_runner(key, DecodeRunner)

    def spec_runner(self, plan: FusionPlan, pixel_values, max_new_tokens: int, m: int,
                    draft: Tuple[int, ...] = (), rounds: int = 1) -> SpecRunner:
        """The speculative runner of ``m`` candidates a round for this batch,
        ``max_new_tokens`` new tokens and drafts from the host (``draft``
        ``()``) or from prompt lookup on the device (``(max_ngram,
        min_ngram)``), ``rounds`` rounds a chunk. The caches have ``m`` slots
        of headroom: the last round may persist up to ``m - 1`` tokens past
        the limit. It takes the ``Generator``'s one runner slot."""
        sizes = self.cache_sizes(plan, pixel_values, max_new_tokens + m)
        key = runner_key(plan.batch, sizes, chunk=rounds)._replace(
            m=m, ctx_cap=plan.seq_len + max_new_tokens + m, draft=tuple(draft))
        return self._keep_runner(key, SpecRunner)

    def prefill_from_plan(self, plan: FusionPlan, pixel_values, max_new_tokens: int,
                          chunk: int = 0):
        """``dynamic.prefill`` of ``plan`` into the cache of ``runner(plan,
        pixel_values, max_new_tokens, chunk)``."""
        cache = self.runner(plan, pixel_values, max_new_tokens, chunk).fresh_cache()
        return self.prefill_into(plan, pixel_values, cache)

    def prefill_into(self, plan: FusionPlan, pixel_values, cache: TieredCache,
                     image_features=None):
        """``dynamic.prefill`` of ``plan`` into ``cache`` (zeroed, of the
        capacities of ``cache_sizes``); ``image_features`` ``[B, N, D]``
        (pre-encoded, in place of ``pixel_values``) are fused at the plan's
        image slots."""
        gc = self.gen_cfg
        all_have_image = self._all_have_image(plan, pixel_values)
        pix = None if pixel_values is None else self._tensor(pixel_values)
        feats = None if image_features is None else self._tensor(image_features)
        i32 = torch.int32
        return dynamic.prefill(
            self.params, self.cfg,
            self._tensor(plan.token_ids, i32),
            self._tensor(plan.is_image, torch.bool),
            self._tensor(plan.image_slot, i32),
            self._tensor(plan.valid_len, i32),
            self._tensor(plan.spans.image_start, i32),
            self._tensor(plan.spans.last_instruct_start, i32),
            self._tensor(plan.spans.last_instruct_end, i32),
            self._tensor(plan.spans.has_image, torch.bool),
            pix,
            cache,
            image_features=feats,
            all_have_image=all_have_image,
            ring_mode=gc.kv_overflow == "ring",
        )

    def cache_lengths(self, state: dynamic.GenState) -> np.ndarray:
        """Per-layer persisted KV lengths ``[L, B]``, pre tier then post."""
        return torch.cat([state.cache.pre.length, state.cache.post.length]).cpu().numpy()

    def generate_speculative(self, input_ids_list, pixel_values=None, draft="prompt_lookup",
                             draft_k: int = 4, stats: Optional[dict] = None, on_tokens=None,
                             max_new_tokens: Optional[int] = None) -> List[List[int]]:
        """Greedy generation through speculative verify rounds with drafts
        from the host: the tokens of ``generate``, fewer decode passes
        (``generation.speculative.generate_speculative``)."""
        return speculative.generate_speculative(
            self, input_ids_list, pixel_values, draft=draft, draft_k=draft_k, stats=stats,
            on_tokens=on_tokens, max_new_tokens=max_new_tokens)

    def generate_speculative_device(self, input_ids_list, pixel_values=None,
                                    draft_k: int = 4,
                                    stats: Optional[dict] = None) -> List[List[int]]:
        """Speculative decode with prompt lookup on the device, the host
        reading once a chunk of rounds
        (``generation.speculative.generate_speculative_device``)."""
        return speculative.generate_speculative_device(
            self, input_ids_list, pixel_values, draft_k=draft_k, stats=stats)

    @torch.inference_mode()
    def generate(
        self,
        input_ids_list: List[np.ndarray],
        pixel_values: Optional[np.ndarray] = None,  # [B, H, W, 3] normalized
        stopping_criteria=None,
        pad_to: Optional[int] = None,
        seed: Optional[int] = None,
        on_chunk=None,  # callback(sample_idx, new_token_ids) for streaming
    ) -> List[List[int]]:
        """Generated token ids (without the prompt) per sample."""
        gc = self.gen_cfg
        plan = plan_batch(
            input_ids_list,
            self.cfg.num_image_tokens if pixel_values is not None else 0,
            max_length=self.cfg.model_max_length,
            pad_to=pad_to,
            pad_multiple=None if pad_to is not None else gc.pad_multiple,
        )
        chunk = decode_chunk_len(gc)
        # the cache has room for whole chunks, as in the JAX generator
        n_chunks = -(-gc.max_new_tokens // chunk)
        state, _ = self.prefill_from_plan(plan, pixel_values, n_chunks * chunk)
        runner = self.runner(plan, pixel_values, n_chunks * chunk)
        runner.load(state, gc.seed if seed is None else seed)
        del state
        return self._drain(runner, plan, n_chunks, stopping_criteria, on_chunk)

    def _drain(self, runner: DecodeRunner, plan: FusionPlan, n_chunks: int,
               stopping_criteria=None, on_chunk=None) -> List[List[int]]:
        """Runs up to ``n_chunks`` chunks of a loaded ``runner`` and returns
        each sample's tokens, cut at EOS, ``max_new_tokens`` or
        ``stopping_criteria``."""
        gc = self.gen_cfg
        b = plan.batch
        done = np.zeros(b, bool)
        out: List[List[int]] = [[] for _ in range(b)]
        prompts = [
            list(np.asarray(plan.token_ids[i][: plan.valid_len[i]]))
            for i in range(b)
        ] if stopping_criteria is not None else None
        # pipelined chunks: chunk k+1 is enqueued before chunk k's tokens are
        # read, so the host's work below overlaps the device's; after an
        # early stop the speculative chunk's work is discarded
        pending = runner.run_chunk()
        for ci in range(n_chunks):
            following = runner.run_chunk() if ci + 1 < n_chunks else None
            toks_np = pending.tokens()  # [chunk, B]: ONE host sync per chunk
            for i in range(b):
                if done[i]:
                    continue
                fresh: List[int] = []
                for j in range(toks_np.shape[0]):
                    if len(out[i]) >= gc.max_new_tokens:
                        done[i] = True
                        break
                    t = int(toks_np[j, i])
                    out[i].append(t)
                    fresh.append(t)
                    if t == gc.eos_token_id:
                        done[i] = True
                        break
                    if stopping_criteria is not None and stopping_criteria(
                        prompts[i] + out[i]
                    ):
                        done[i] = True
                        break
                if on_chunk is not None and fresh:
                    on_chunk(i, fresh)
            if done.all():
                break
            pending = following
        return out

    def anyres_inputs(self, input_ids_list: List[np.ndarray], images, grid_pinpoints,
                      image_processor, merge_type: str = "spatial_unpad"):
        """High-resolution inputs: each PIL image tiled on the host
        (``mm_utils.process_anyres_image``), its tiles encoded on the device
        and merged on the host (``multimodal.anyres``), and the batch
        planned with each image's merged token count, cut at
        ``model_max_length`` as the JAX ``generate_anyres`` plans it.
        Returns ``(plan, features [B, N_max, D] float32, per-image token
        counts)``."""
        from ..mm_utils import process_anyres_image
        from ..multimodal.anyres import encode_images_anyres

        tiles_list = [process_anyres_image(im, image_processor, grid_pinpoints)
                      for im in images]
        feats = encode_images_anyres(self.params, self.cfg, tiles_list,
                                     [im.size for im in images], grid_pinpoints, merge_type)
        counts = [f.shape[0] for f in feats]
        feat_pad = np.zeros((len(feats), max(counts), feats[0].shape[1]), np.float32)
        for i, f in enumerate(feats):
            feat_pad[i, : f.shape[0]] = f
        plan = plan_batch(input_ids_list, 0, tokens_per_image_list=[[n] for n in counts],
                          max_length=self.cfg.model_max_length)
        return plan, feat_pad, counts

    def prefill_anyres(self, plan: FusionPlan, features, max_new_tokens: int):
        """``dynamic.prefill`` of ``plan`` with pre-encoded ``features`` into
        the cache of the kept runner for ``max_new_tokens`` new tokens. The
        capacities are the JAX ``generate_anyres``'s ``make_gen_cache``:
        the bounded output budget, no bucket, the post tier at the full
        prompt (no vision prune)."""
        gc = self.gen_cfg
        sizes = dynamic.gen_cache_sizes(
            self.cfg, plan.seq_len, max_new_tokens, all_have_image=False,
            decode_window=gc.kv_window, ring=gc.kv_overflow == "ring")
        runner = self._keep_runner(runner_key(plan.batch, sizes), DecodeRunner)
        return self.prefill_into(plan, None, runner.fresh_cache(), image_features=features)

    @torch.inference_mode()
    def generate_anyres(
        self,
        input_ids_list: List[np.ndarray],
        images,  # PIL images
        grid_pinpoints,
        image_processor,
        merge_type: str = "spatial_unpad",
    ) -> List[List[int]]:
        """High-resolution (anyres) generation: tile and encode
        (``anyres_inputs``), prefill on the pre-encoded features
        (``prefill_anyres``), then the decode chunks of ``generate`` on the
        kept runner. The vision predictor is skipped (it assumes the
        standard tower); the instruct and output-text predictors apply."""
        gc = self.gen_cfg
        plan, feats, _ = self.anyres_inputs(input_ids_list, images, grid_pinpoints,
                                            image_processor, merge_type)
        chunk = decode_chunk_len(gc)
        n_chunks = -(-gc.max_new_tokens // chunk)
        state, _ = self.prefill_anyres(plan, feats, n_chunks * chunk)
        runner = self.decode_runner
        runner.load(state, gc.seed)
        del state
        return self._drain(runner, plan, n_chunks)


class ChatSession:
    """Multi-round chat on ONE live KV cache (the JAX ``ChatSession``).

    Round 1 runs the multimodal prefill; a later round feeds only its new
    chunk through the continuation prefill (``dynamic.prefill_continue``)
    instead of prefilling the whole conversation again. Decode rides a
    ``StopDecodeRunner``: EOS and the keyword stops freeze the sample on the
    device, so the cache holds exactly the emitted tokens while the host
    reads once a chunk (chunk k+1 enqueued before chunk k is read). A
    stopping criterion without ``keyword_ids`` takes the exact per-token
    path (``_ask_tokenwise``). A criterion is duck-typed: ``keyword_ids``
    (token sequences, matched on the device) and ``tokenizer`` (it also has
    a decoded-text test, checked on the host a chunk; where it fires before
    the token matcher, the state is rebuilt exactly by replay).

    The session owns its runner (its KV cache, small buffers and graph),
    made at round 1 for ``max_new_tokens_total`` new tokens and apart from
    the ``Generator``'s runner, so ``Generator.generate`` between two rounds
    leaves the conversation alone. ``state`` is that runner's state."""

    def __init__(self, generator: Generator, max_new_tokens_total: int = 2048):
        if generator.gen_cfg.kv_overflow != "drop":
            # the continuation force-drops at capacity instead of wrapping: a
            # wrapped ring cache would silently lose chunk KV
            raise ValueError(
                "ChatSession requires kv_overflow='drop'; the ring mode is a "
                "single-conversation long-generation contract")
        self.gen = generator
        self.budget = max_new_tokens_total
        self.runner: Optional[StopDecodeRunner] = None
        # replay log of the text-fallback stop: ("prefill", ids, pixels),
        # ("chunk", ids) or ("out", tokens fed through decode)
        self._hist: List[tuple] = []

    @property
    def state(self) -> Optional[dynamic.GenState]:
        return None if self.runner is None else self.runner.state

    def _load(self, state: dynamic.GenState) -> None:
        """Take a state computed on the runner's cache into its buffers."""
        self.runner.load(state, self.gen.gen_cfg.seed)

    def _plan(self, ids, pixel_values) -> FusionPlan:
        cfg = self.gen.cfg
        return plan_batch([ids], cfg.num_image_tokens if pixel_values is not None else 0,
                          max_length=cfg.model_max_length)

    def _prefill(self, ids, pixel_values) -> None:
        gen, gc = self.gen, self.gen.gen_cfg
        plan = self._plan(ids, pixel_values)
        if self.runner is None:
            key = runner_key(plan.batch, gen.cache_sizes(plan, pixel_values, self.budget),
                             stop=((gc.eos_token_id,),), chunk=decode_chunk_len(gc))
            self.runner = StopDecodeRunner(gen.params, gen.cfg, gc, key, gen.device)
        state, _ = gen.prefill_into(plan, pixel_values, self.runner.fresh_cache())
        self._load(state)

    def _continue(self, ids) -> None:
        gen = self.gen
        tokens = torch.as_tensor(np.asarray(ids, np.int64)[None]).to(gen.device)
        self._load(dynamic.prefill_continue(gen.params, gen.cfg, tokens, self.state))

    def _decode_fed(self, tokens) -> None:
        """Feed tokens one by one through ``decode_step`` (eager)."""
        gen = self.gen
        state = self.state
        for tok in tokens:
            state = dynamic.decode_step(
                gen.params, gen.cfg, torch.full((1,), int(tok), device=gen.device), state)
        self._load(state)

    @torch.inference_mode()
    def _start_round(self, input_ids, pixel_values, reserve: int = 0) -> None:
        """Prefill round 1 or continue with a later round's chunk, after
        checking that the pre tier (which persists every token) has room for
        the chunk and for ``reserve`` new tokens after it: a decode step past
        the capacity would write out of bounds."""
        ids = np.asarray(input_ids, np.int64)
        if self.runner is None:
            plan = self._plan(ids, pixel_values)
            pre_len = self.gen.cache_sizes(plan, pixel_values, self.budget)[0]
            pre_room = pre_len - 1 - int(plan.valid_len[0])
            chunk = 0
        else:
            # the chunk goes to slots below the scratch slot max_len - 1
            pre = self.state.cache.pre
            pre_room = pre.max_len - 1 - int(pre.length.max())
            chunk = len(ids)
            if chunk > pre_room:
                raise ValueError(
                    f"chunk of {chunk} tokens exceeds remaining cache capacity "
                    f"{pre_room}; raise max_new_tokens_total")
        if chunk + reserve > pre_room:
            raise ValueError(
                f"{chunk} chunk tokens and {reserve} new tokens exceed remaining cache "
                f"capacity {pre_room}; raise max_new_tokens_total")
        if self.runner is None:
            self._hist.append(
                ("prefill", ids.copy(),
                 None if pixel_values is None else np.asarray(pixel_values)))
            self._prefill(ids, pixel_values)
        else:
            self._hist.append(("chunk", ids.copy()))
            self._continue(ids)

    @torch.inference_mode()
    def _replay_state(self) -> None:
        """Rebuild the live state exactly from the replay log: prefill round
        1 again, run each chunk, feed every recorded token through the
        per-token decode (the keep / drop decisions depend on hidden states,
        not on sampling, so the replay is exact). Only the text-fallback
        stop of ``ask`` needs it."""
        for entry in self._hist:
            if entry[0] == "prefill":
                self._prefill(entry[1], entry[2])
            elif entry[0] == "chunk":
                self._continue(entry[1])
            else:
                self._decode_fed(entry[1])

    def _stop_runner(self, stop, chunk: int) -> StopDecodeRunner:
        """The runner for these stop sequences and chunk: the session's, or
        a new one on the same buffers (a new capture) when its key differs."""
        key = self.runner.key._replace(stop=stop, chunk=chunk, q4_mlp=q4_mlp_enabled())
        if key != self.runner.key:
            gen = self.gen
            state = self.runner.state
            self.runner = None  # the old graph goes before the new one comes
            self.runner = StopDecodeRunner(gen.params, gen.cfg, gen.gen_cfg, key, gen.device,
                                           state=state)
        return self.runner

    @torch.inference_mode()
    def ask(
        self,
        input_ids,  # round 1: the full prompt; later: the new chunk only
        pixel_values: Optional[np.ndarray] = None,
        stopping_criteria=None,
        max_new_tokens: Optional[int] = None,
        stop_sequences: Optional[List[List[int]]] = None,
        on_chunk=None,  # callback(new_token_ids) for streaming
    ) -> List[int]:
        """The round's answer token ids. EOS is processed into the cache
        but left out of the answer; keyword-stop tokens stay."""
        gc = self.gen.gen_cfg
        max_new = gc.max_new_tokens if max_new_tokens is None else max_new_tokens
        self._start_round(input_ids, pixel_values, reserve=max(0, max_new))
        if max_new <= 0:
            # the chunk is processed, nothing is sampled
            self._hist.append(("out", []))
            return []

        stop_seqs = [(gc.eos_token_id,)]
        crit, text_crit = stopping_criteria, None
        if crit is not None and hasattr(crit, "keyword_ids"):
            # keyword criteria: their token sequences stop on the device; a
            # decoded-text test (with a tokenizer) is the host's safety net
            stop_seqs += [tuple(int(t) for t in kid) for kid in crit.keyword_ids]
            text_crit = crit if hasattr(crit, "tokenizer") else None
            crit = None
        if stop_sequences:
            stop_seqs += [tuple(int(t) for t in seq) for seq in stop_sequences]
        if crit is not None:
            return self._ask_tokenwise(crit, max_new)

        runner = self._stop_runner(tuple(dict.fromkeys(stop_seqs)),
                                   max(1, min(gc.decode_chunk, max_new)))
        runner.begin(max_new, gc.seed)
        out: List[int] = []
        fired_at = None  # the earliest text-fallback stop (a token count)
        pending = runner.run_chunk()
        while True:
            # the next chunk is enqueued before this one is read; once the
            # sample has stopped it runs frozen and leaves the state as it was
            following = runner.run_chunk()
            toks, emitted, active = runner.read(pending)
            fresh = [int(t) for t, e in zip(toks[:, 0], emitted[:, 0]) if e]
            out.extend(fresh)
            if on_chunk is not None and fresh:
                on_chunk(fresh)
            if text_crit is not None and fresh and fired_at is None:
                for j in range(len(out) - len(fresh) + 1, len(out) + 1):
                    if text_crit(out[:j]):
                        fired_at = j
                        break
            inactive = not bool(active[0])
            if fired_at is not None and not (inactive and fired_at == len(out)):
                # the text test caught a stop the token matcher missed: cut
                # the answer there and rebuild the state the per-token path
                # would have (the tokens past the stop were persisted)
                out = out[:fired_at]
                self._hist.append(("out", list(out)))
                self._replay_state()
                return out
            if inactive:
                break
            pending = following
        self._hist.append(("out", list(out)))  # every emitted token was fed
        if out and out[-1] == gc.eos_token_id:
            out.pop()
        return out

    @torch.inference_mode()
    def _ask_tokenwise(self, stopping_criteria, max_new: int) -> List[int]:
        """The exact per-token loop for any host-side stopping criteria: one
        host read a token. Every emitted token is fed through decode, the
        one that trips EOS or the criteria too."""
        gen, gc = self.gen, self.gen.gen_cfg
        out: List[int] = []
        fed: List[int] = []
        state = self.state
        for _ in range(max_new):
            tok = int(torch.argmax(state.last_logits[0]))
            state = dynamic.decode_step(
                gen.params, gen.cfg, torch.full((1,), tok, device=gen.device), state)
            fed.append(tok)
            if tok == gc.eos_token_id:
                break
            out.append(tok)
            if stopping_criteria is not None and stopping_criteria(out):
                break
        self._load(state)
        self._hist.append(("out", fed))
        return out

    def cache_lengths(self) -> np.ndarray:
        """Per-layer persisted KV lengths ``[L, 1]``, pre tier then post."""
        if self.state is None:
            raise RuntimeError("ChatSession.cache_lengths: no round yet")
        return torch.cat([self.state.cache.pre.length,
                          self.state.cache.post.length]).cpu().numpy()
