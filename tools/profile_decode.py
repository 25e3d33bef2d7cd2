#!/usr/bin/env python3
"""Where a decode step's time goes in the PyTorch/CUDA port, eager against
CUDA graph, per weight kind and mode.

    python3 tools/profile_decode.py

Run from the root of a checkout on one CUDA card (about 25 GB of device
memory). At LLaVA-1.5-7B width (random weights from seed 0) it plans the
batch ``chip_smoke.py`` serves (8 requests, one 336x336 image and 60 text
tokens each, 64 new tokens) and runs, in one process, bf16 weights sparse
and dense, the same weights quantized in place to int8, then an int4
decoder made directly: sparse, dense, with the fused MLP (K9,
``DYNAMIC_LLAVA_Q4_MLP=1``), fused with the KV cache stored in scaled int8,
two-kernel with the int8 cache sparse and dense, and two-kernel once more
(the fused and two-kernel modes alternate). For each mode:

* prefill (``Generator.prefill_from_plan``) three times on the host clock
  after ``synchronize``, the middle one kept, and one more recorded with
  ``torch.profiler``, its device time summed in the buckets below;
* decode tok/s as ``chip_smoke.py`` reads it: ``B * 64 / (generate - TTFT)``
  for the second of two ``Generator.generate`` calls (the first captures
  the decode graph), TTFT being the prefill wall above;
* the step wall, in turns eager, graph, whole-chunk graph, graph, eager:
  eager = 16 steps of greedy sample + ``dynamic.decode_step`` after 4
  warm-up steps; graph = the ``Generator``'s runner replaying its one-step
  graph over two chunks (64 steps, chunk k+1 enqueued before chunk k's
  tokens are read); whole-chunk graph = the same 64 steps from a graph that
  holds a whole chunk (32 steps), captured here from the runner's step;
* device time per step by bucket from ``torch.profiler`` (CPU and CUDA
  activities) over 16 eager steps and over 64 graph steps: K5-K8
  (``gemv_tc_kernel`` / ``gemv_fma_kernel``), K9 (``q4_mlp_kernel``), K2
  (``decode_kernel``), K1 (``flash_fwd_*``), cuBLAS (``gemm``, ``gemv``,
  ``nvjet``, ``cutlass``, ``xmma``, ``splitK`` names that are not the port's
  own) and other. Idle share = 1 - device busy / step wall. Beside it, the
  graph's device time from CUDA events around the 64 replays.

It prints the card's name and power limit, one line per mode, and one JSON
object as the last line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SEED, B, N_TEXT, MAX_NEW = 0, 8, 60, 64
WARM, STEPS = 4, 16
# bucket -> kernel-name fragments; the port's kernels are matched first
BUCKETS = (
    ("K5-K8", ("gemv_tc_kernel", "gemv_fma_kernel")),
    ("K9", ("q4_mlp_kernel",)),
    ("K2", ("decode_kernel",)),
    ("K1", ("flash_fwd_",)),
    ("cuBLAS", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitK")),
)


def bucket(name: str) -> str:
    for label, parts in BUCKETS:
        if any(p in name for p in parts):
            return label
    return "other"


def sum_device_ms(prof, per: int = 1):
    """``(ms by bucket, ms by kernel name, launches by kernel name)`` of the
    device activity a profiler recorded, times divided by ``per``."""
    from torch.autograd import DeviceType

    per_bucket, per_kernel, launches = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3 / per
            per_bucket[bucket(e.name)] += ms
            per_kernel[e.name] += ms
            launches[e.name] += 1
    return per_bucket, per_kernel, launches


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def profile(torch, params, cfg, kind, cache_dtype="bfloat16", fused=False):
    """The measurements of one mode (see the module docstring), with the KV
    cache stored in ``cache_dtype`` and the fused int4 MLP on or off."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.models import dynamic
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch

    rng = np.random.default_rng(SEED)
    vocab, size = cfg.text.vocab_size, cfg.vision.image_size
    ids = [np.concatenate([rng.integers(3, vocab, N_TEXT // 2), [IMAGE_TOKEN_INDEX],
                           rng.integers(3, vocab, N_TEXT - N_TEXT // 2)])
           for _ in range(B)]
    pix = rng.standard_normal((B, size, size, 3), dtype=np.float32)
    gc = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1, cache_dtype=cache_dtype)
    os.environ.pop("DYNAMIC_LLAVA_Q4_MLP", None)
    if fused:
        os.environ["DYNAMIC_LLAVA_Q4_MLP"] = "1"
    plan = plan_batch(ids, cfg.num_image_tokens, pad_multiple=gc.pad_multiple)
    gen = Generator(params, cfg, gc)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def eager_steps(state, n):
        for _ in range(n):
            tok = torch.argmax(state.last_logits, dim=-1)
            state = dynamic.decode_step(params, cfg, tok, state)
        return state

    def eager_wall():
        state, _ = gen.prefill_from_plan(plan, pix, MAX_NEW)
        state = eager_steps(state, WARM)
        return timed(lambda: eager_steps(state, STEPS)) / STEPS

    def loaded_runner():
        state, _ = gen.prefill_from_plan(plan, pix, MAX_NEW)
        runner = gen.runner(plan, pix, MAX_NEW)
        runner.load(state, 0)
        return runner

    with torch.inference_mode():
        prefill = [timed(lambda: gen.prefill_from_plan(plan, pix, MAX_NEW)) for _ in range(3)]
        with torch_profile(activities=activities) as pre:
            gen.prefill_from_plan(plan, pix, MAX_NEW)
            torch.cuda.synchronize()
        ttft = statistics.median(prefill)
        gen.generate(ids, pix)  # captures the decode step
        gen_ms = timed(lambda: gen.generate(ids, pix))
        runner = gen.decode_runner
        require(runner.graph is not None, f"{kind}: decode took no CUDA graph")

        # a graph of a whole chunk, captured here from the runner's step
        loaded_runner()
        chunk_graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(chunk_graph):
            for _ in range(runner.chunk):
                runner.step()
        chunk_capture_ms = (time.perf_counter() - t0) * 1e3

        def chunk_graph_run():
            r = loaded_runner()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MAX_NEW // r.chunk):
                chunk_graph.replay()
            r.toks.cpu()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / MAX_NEW

        def graph_wall():
            r = loaded_runner()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pending = [r.run_chunk() for _ in range(MAX_NEW // r.chunk)]
            for p in pending:
                p.tokens()
            return (time.perf_counter() - t0) * 1e3 / MAX_NEW

        eager_a, graph_a, chunk_ms, graph_b, eager_b = (
            eager_wall(), graph_wall(), chunk_graph_run(), graph_wall(), eager_wall())

        state, _ = gen.prefill_from_plan(plan, pix, MAX_NEW)
        state = eager_steps(state, WARM)
        torch.cuda.synchronize()
        with torch_profile(activities=activities) as prof_eager:
            eager_steps(state, STEPS)
            torch.cuda.synchronize()
        r = loaded_runner()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(MAX_NEW):
            r.graph.replay()
        end.record()
        torch.cuda.synchronize()
        graph_event_ms = start.elapsed_time(end) / MAX_NEW
        r = loaded_runner()
        torch.cuda.synchronize()
        with torch_profile(activities=activities) as prof_graph:
            for _ in range(MAX_NEW):
                r.graph.replay()
            torch.cuda.synchronize()
    os.environ.pop("DYNAMIC_LLAVA_Q4_MLP", None)
    capture_ms = runner.capture_ms
    del chunk_graph, gen, runner, r, state
    torch.cuda.empty_cache()

    eager_step, graph_step = (eager_a + eager_b) / 2, (graph_a + graph_b) / 2
    eb, ek, el = sum_device_ms(prof_eager, STEPS)
    gb, gk, _ = sum_device_ms(prof_graph, MAX_NEW)
    pre_bucket = sum_device_ms(pre)[0]
    eager_busy, graph_busy = sum(eb.values()), sum(gb.values())
    require(eager_busy > 0, f"{kind}: the profiler saw no device time")
    top = sorted(ek.items(), key=lambda kv: -kv[1])[:6]
    res = dict(
        prefill_wall_ms=ttft, prefill_device_ms=sum(pre_bucket.values()),
        prefill_buckets_ms=dict(pre_bucket),
        generate_ms=gen_ms, decode_tok_s=B * MAX_NEW / ((gen_ms - ttft) / 1e3),
        capture_ms=capture_ms, chunk_capture_ms=chunk_capture_ms,
        eager=dict(step_wall_ms=eager_step, walls_ms=[eager_a, eager_b],
                   device_busy_ms=eager_busy, idle_share=max(0.0, 1 - eager_busy / eager_step),
                   buckets_ms=dict(eb)),
        graph=dict(step_wall_ms=graph_step, walls_ms=[graph_a, graph_b],
                   device_busy_ms=graph_busy, event_ms=graph_event_ms,
                   idle_share=max(0.0, 1 - graph_busy / graph_step) if graph_busy else None,
                   buckets_ms=dict(gb)),
        chunk_graph=dict(step_wall_ms=chunk_ms),
        top=[dict(name=n, ms=ms, launches_per_step=el[n] / STEPS) for n, ms in top])
    gi = res["graph"]["idle_share"]
    print(f"{kind} B={B}: prefill wall {ttft:.3f} ms (device {res['prefill_device_ms']:.3f}); "
          f"decode {res['decode_tok_s']:.1f} tok/s (generate {gen_ms:.1f} ms); step wall "
          f"eager {eager_a:.3f} / {eager_b:.3f} ms, graph {graph_a:.3f} / {graph_b:.3f} ms, "
          f"whole-chunk graph {chunk_ms:.3f} ms; device busy eager {eager_busy:.3f} ms "
          f"(idle {res['eager']['idle_share']:.3f}), graph {graph_busy:.3f} ms (idle "
          f"{'not measured' if gi is None else f'{gi:.3f}'}), graph by events "
          f"{graph_event_ms:.3f} ms; capture {capture_ms:.1f} ms (whole chunk "
          f"{chunk_capture_ms:.1f} ms)", flush=True)
    print("    graph step ms by bucket: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(gb.items()))
          + "; eager: " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(eb.items())), flush=True)
    for t in res["top"]:
        print(f"    {t['name'][:100]} {t['ms']:.3f} ms/step, "
              f"{t['launches_per_step']:g} launches/step", flush=True)
    return res


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_decode.py: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    from dynamic_llava_tpu_torch import kernels
    from dynamic_llava_tpu_torch.config import DENSE_SPARSE_CONFIG, LlavaConfig
    from dynamic_llava_tpu_torch.ops.quant import (
        init_quantized_llama_params, quantize_llm_params)
    from dynamic_llava_tpu_torch.weights import init_llava_params

    kernels.load_library()
    cfg, dev = LlavaConfig(), torch.device("cuda")
    dense = LlavaConfig(sparse=DENSE_SPARSE_CONFIG)
    params = init_llava_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                               torch.bfloat16)
    out = {"bf16": profile(torch, params, cfg, "bf16"),
           "bf16 dense": profile(torch, params, dense, "bf16 dense")}
    quantize_llm_params(params, bits=8)
    out["int8"] = profile(torch, params, cfg, "int8")
    del params["llm"]
    torch.cuda.empty_cache()
    params["llm"] = init_quantized_llama_params(
        cfg.text, torch.Generator(device=dev).manual_seed(SEED), dev, bits=4)
    # two-kernel and fused modes alternate: the host's pace drifts within a call
    int8kv = dict(cache_dtype="int8")
    for kind, c, kw in [
        ("int4", cfg, {}), ("int4 dense", dense, {}),
        ("int4 fused MLP", cfg, dict(fused=True)),
        ("int4 fused MLP int8 KV", cfg, dict(fused=True, **int8kv)),
        ("int4 int8 KV", cfg, int8kv), ("int4 int8 KV dense", dense, int8kv),
        ("int4, again", cfg, {}),
    ]:
        out[kind] = profile(torch, params, c, kind, **kw)
    print(json.dumps({"device": smi, "b8": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
