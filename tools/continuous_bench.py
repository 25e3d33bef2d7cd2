#!/usr/bin/env python3
"""Continuous batching against the window batcher on the card, in turns.

    python3 tools/continuous_bench.py [--rounds 4] [--int8]

Run from the root of a checkout on one CUDA card (about 45 GB of device
memory). At LLaVA-1.5-7B width (random bf16 weights from seed 0, sparse)
it serves the trace of ``chip_smoke.py`` phase 5d
(``chip_smoke.continuous_trace``: 16 requests of one 336x336 image and 60
text tokens, 64 and 128 new tokens in turn, EOS off, one every 300 ms)
through three arms kept alive side by side, each prewarmed once: the
``ContinuousEngine`` (8 slots, chunks of 16; two requests sample), the
window batcher (``chip_smoke.window_pass``) and the engine with
``spec_k=4``. Then ``--rounds`` rounds of one timed pass an arm, arrivals
at their times, the order of the arms reversed every round (engine,
window, spec, spec, window, engine, ...), admissions timed between
synchronizations as in ``chip_smoke.py``. For each arm it reports the
median and the quartiles over the rounds of the makespan, aggregate tok/s,
completion latency (arrival -> last token) and TTFT (arrival -> first
token), mean and p95 each, and the admissions' ms by batch size. Then one
more pass an arm under ``torch.profiler`` (CUDA activity): the device's
busy ms by bucket (K1 ``flash_fwd_*``, K2 ``decode_kernel``, K2-M
``extend_*kernel``, K5/K6 ``gemv_*``, cuBLAS, other) and the idle share,
1 - busy / makespan of that pass (which the tracing slows).

``--int8`` runs the same after quantizing the decoder in place to int8,
with an fp8 KV cache. It prints the card's name and power limit, a line an
arm and round, and one JSON object as the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
# bucket -> kernel-name fragments, the port's kernels first
BUCKETS = (
    ("K1", ("flash_fwd_",)),
    ("K2", ("decode_kernel",)),
    ("K2-M", ("extend_mma_kernel", "extend_kernel")),
    ("K5/K6", ("gemv_tc_kernel", "gemv_fma_kernel")),
    ("cuBLAS", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitK")),
)
STATS = ("makespan_s", "tok_s", "latency_mean_s", "latency_p95_s", "ttft_mean_s",
         "ttft_p95_s")


def bucket(name: str) -> str:
    for label, parts in BUCKETS:
        if any(p in name for p in parts):
            return label
    return "other"


def traced(torch, fn):
    """``(fn(), busy ms by bucket)`` from one profiler trace of the CUDA
    activity (kernels on the port's one stream do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    busy = defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy[bucket(e.name())] += e.duration_ns() / 1e6
    return out, dict(busy)


def quartiles(xs):
    q1, q2, q3 = np.quantile(xs, [0.25, 0.5, 0.75])
    return dict(median=float(q2), q1=float(q1), q3=float(q3))


def bench(torch, cs, params, cfg, rounds, gen_fields, label):
    """The arms of one weight / cache mode (see the module docstring)."""
    from dynamic_llava_tpu_torch.generation.continuous import ContinuousEngine
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator

    reqs = cs.continuous_trace(cfg)
    new = max(cs.CONT_MAX_NEW)
    gc = GenerationConfig(max_new_tokens=new, decode_chunk=cs.CONT_CHUNK, eos_token_id=-1,
                          **gen_fields)
    engines = {
        "engine": ContinuousEngine(params, cfg, gc, slots=cs.CONT_SLOTS,
                                   prompt_bucket=cs.CONT_BUCKET, max_new_cap=new),
        f"engine spec k={cs.CONT_SPEC_K}": ContinuousEngine(
            params, cfg, gc, slots=cs.CONT_SLOTS, prompt_bucket=cs.CONT_BUCKET,
            max_new_cap=new, spec_k=cs.CONT_SPEC_K),
    }
    gens = {mn: Generator(params, cfg, GenerationConfig(
        max_new_tokens=mn, decode_chunk=cs.CONT_CHUNK, eos_token_id=-1, **gen_fields))
        for mn in sorted(set(cs.CONT_MAX_NEW))}
    first = reqs[0]
    for e in engines.values():
        e.prewarm(first["ids"], first["pix"])
    for g in gens.values():
        g.generate([first["ids"]] * cs.CONT_SLOTS,
                   np.stack([first["pix"]] * cs.CONT_SLOTS), pad_to=cs.CONT_BUCKET)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30

    def run(arm, admissions=None):
        if arm == "window":
            return cs.window_pass(torch, gens, reqs, cs.CONT_SLOTS)
        engine = engines[arm]
        return cs.engine_pass(torch, engine, reqs, not engine.spec_k, True, admissions)

    arms = ["engine", "window", f"engine spec k={cs.CONT_SPEC_K}"]
    per_arm = {a: defaultdict(list) for a in arms}
    admissions = {a: {} for a in arms}
    for rnd in range(rounds):
        for arm in (arms if rnd % 2 == 0 else arms[::-1]):
            st = cs.pass_stats(reqs, run(arm, admissions[arm]))
            for k in STATS:
                per_arm[arm][k].append(st[k])
            print(f"{label} round {rnd} {arm}: " + ", ".join(
                f"{k} {st[k]:.4f}" for k in STATS), flush=True)
    results = {}
    for arm in arms:
        r = {k: quartiles(v) for k, v in per_arm[arm].items()}
        r["runs"] = {k: v for k, v in per_arm[arm].items()}
        if admissions[arm]:
            r["admission_ms"] = {k: quartiles(v) for k, v in sorted(admissions[arm].items())}
        run_out, busy = traced(torch, lambda: run(arm))
        makespan = run_out["makespan"]
        r["traced"] = dict(makespan_s=makespan, busy_ms=busy,
                           idle_share=1 - sum(busy.values()) / 1e3 / makespan)
        results[arm] = r
        print(f"{label} {arm}: median makespan {r['makespan_s']['median']:.4f} s "
              f"(q1 {r['makespan_s']['q1']:.4f}, q3 {r['makespan_s']['q3']:.4f}), tok/s "
              f"{r['tok_s']['median']:.2f}, latency mean {r['latency_mean_s']['median']:.4f} s, "
              f"TTFT mean {r['ttft_mean_s']['median']:.4f} s; traced pass {makespan:.3f} s, "
              f"busy {json.dumps({k: round(v, 1) for k, v in busy.items()})} ms, idle share "
              f"{r['traced']['idle_share']:.3f}", flush=True)
    results["resident_gib"] = resident
    del engines, gens
    return results


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--int8", action="store_true",
                   help="also run on the decoder quantized to int8, with an fp8 KV cache")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("continuous_bench.py: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from dynamic_llava_tpu_torch import kernels
    from dynamic_llava_tpu_torch.config import LlavaConfig
    from dynamic_llava_tpu_torch.ops.quant import quantize_llm_params
    from dynamic_llava_tpu_torch.weights import init_llava_params

    kernels.load_library()
    cfg = LlavaConfig()
    dev = torch.device("cuda")
    params = init_llava_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev,
                               torch.bfloat16)
    t0 = time.perf_counter()
    out = {"card": smi, "rounds": args.rounds,
           "bf16": bench(torch, cs, params, cfg, args.rounds, {}, "bf16")}
    if args.int8:
        quantize_llm_params(params, bits=8)
        out["int8 fp8-KV"] = bench(torch, cs, params, cfg, args.rounds,
                                   dict(cache_dtype="float8_e4m3fn"), "int8 fp8-KV")
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
