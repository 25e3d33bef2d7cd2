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

Every kernel wrapper counts its host calls in ``<wrapper>.launches``: an
eager launch, or the one launch a capture records into the graph. A
graph's replays launch on the device without a host call, so their
launches are counted in a profiler trace (``kernel_cases.device_launches``).

Lean-memory options, as in the JAX package: ``cache_dtype`` stores the KV
cache in bf16 / fp32, scaled int8 (``"int8"``) or fp8
(``"float8_e4m3fn"``); ``kv_overflow="ring"`` with ``kv_window`` bounds
both tiers for long generations (each new token past the budget evicts the
oldest decode entry).
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import LlavaConfig
from ..models import dynamic
from ..multimodal.fusion import FusionPlan, plan_batch
from ..ops.kv_cache import TieredCache, init_tiered_cache
from ..ops.quant import q4_mlp_enabled


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


def decode_chunk_len(gc: GenerationConfig) -> int:
    """Decode steps a chunk (the host syncs once a chunk)."""
    return max(1, min(gc.decode_chunk, gc.max_new_tokens))


class RunnerKey(NamedTuple):
    """What a captured decode step depends on beyond the ``Generator``'s
    params and config (sampling, cache dtype, overflow policy and chunk are
    fixed by its ``GenerationConfig``)."""

    batch: int
    pre_len: int  # tier capacities
    post_len: int
    q4_mlp: bool  # DYNAMIC_LLAVA_Q4_MLP, read at every dispatch: a graph freezes it


def runner_key(batch: int, capacities: Tuple[int, int]) -> RunnerKey:
    return RunnerKey(batch, *capacities, q4_mlp_enabled())


class PendingChunk:
    """A chunk's tokens on their way to the host: the ``index``-th chunk of
    ``runner``, in one of its two host buffers."""

    def __init__(self, runner: "DecodeRunner", index: int, host: torch.Tensor,
                 event: Optional[torch.cuda.Event]):
        self.runner, self.index, self.host, self.event = runner, index, host, event

    def tokens(self) -> np.ndarray:
        """Waits for the chunk; ``[chunk, B]`` int32 token ids."""
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
                 device):
        self.params, self.cfg, self.key = params, cfg, key
        self.temperature, self.top_p = gc.temperature, gc.top_p
        self.kv_overflow, self.chunk = gc.kv_overflow, decode_chunk_len(gc)
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        b, ring = key.batch, gc.kv_overflow == "ring"
        # normal (not inference) tensors: written inside and outside inference mode
        with torch.inference_mode(False):
            i32 = dict(dtype=torch.int32, device=self.device)
            self.state = dynamic.GenState(
                cache=init_tiered_cache(cfg.text, cfg.sparse.sparse_layer, b, key.pre_len,
                                        key.post_len, CACHE_DTYPES[gc.cache_dtype],
                                        self.device),
                next_pos=torch.zeros(b, **i32),
                last_logits=torch.zeros(b, cfg.text.vocab_size, dtype=torch.float32,
                                        device=self.device),
                ring_base=torch.zeros(b, **i32) if ring else None,
                ring_base_pre=torch.zeros(b, **i32) if ring else None,
            )
            self.toks = torch.zeros(self.chunk, b, **i32)
            self.step_index = torch.zeros(1, dtype=torch.long, device=self.device)
        self.generator = (None if gc.temperature <= 0.0
                          else torch.Generator(device=self.device))
        # two host buffers: chunk k's is read while chunk k+1's copy is in flight
        self.host = [torch.zeros(self.chunk, b, dtype=torch.int32, pin_memory=self.graphed)
                     for _ in range(2)]
        self.chunks_run = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_ms: Optional[float] = None

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

    def step(self) -> None:
        """One decode step on the static buffers (device work only)."""
        tok = _sample(self.generator, self.state.last_logits, self.temperature, self.top_p)
        new = dynamic.decode_step(self.params, self.cfg, tok, self.state,
                                  kv_overflow=self.kv_overflow)
        for src, dst in self._fresh_outputs(new):
            dst.copy_(src)
        self.toks.index_copy_(0, self.step_index, tok.to(torch.int32)[None])
        self.step_index.add_(1).remainder_(self.chunk)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            self.step()
        torch.cuda.synchronize()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph = graph

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
                self._capture()
                continue
            self.graph.replay()
        index = self.chunks_run
        host = self.host[index % 2]
        self.chunks_run += 1
        host.copy_(self.toks, non_blocking=self.graphed)
        event = None
        if self.graphed:
            event = torch.cuda.Event()
            event.record()
        return PendingChunk(self, index, host, event)


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

    def runner(self, plan: FusionPlan, pixel_values, max_new_tokens: int) -> DecodeRunner:
        """The runner for this batch shape, the tier capacities of
        ``max_new_tokens`` and the current dispatch settings: the one kept
        if its key is the same, else a new one that replaces it."""
        gc = self.gen_cfg
        sizes = dynamic.gen_cache_sizes(
            self.cfg, plan.seq_len, max_new_tokens,
            bound_output_budget=gc.bound_kv_budget,
            all_have_image=self._all_have_image(plan, pixel_values),
            bucket=gc.pad_multiple,
            decode_window=gc.kv_window,
            ring=gc.kv_overflow == "ring",
        )
        key = runner_key(plan.batch, sizes)
        if self.decode_runner is None or self.decode_runner.key != key:
            self.decode_runner = None  # the old cache and graph go before the new ones come
            self.decode_runner = DecodeRunner(self.params, self.cfg, gc, key, self.device)
        return self.decode_runner

    def prefill_from_plan(self, plan: FusionPlan, pixel_values, max_new_tokens: int):
        gc = self.gen_cfg
        all_have_image = self._all_have_image(plan, pixel_values)
        cache = self.runner(plan, pixel_values, max_new_tokens).fresh_cache()
        pix = None if pixel_values is None else self._tensor(pixel_values)
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
            all_have_image=all_have_image,
            ring_mode=gc.kv_overflow == "ring",
        )

    def cache_lengths(self, state: dynamic.GenState) -> np.ndarray:
        """Per-layer persisted KV lengths ``[L, B]``, pre tier then post."""
        return torch.cat([state.cache.pre.length, state.cache.post.length]).cpu().numpy()

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
