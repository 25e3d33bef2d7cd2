#!/usr/bin/env python3
"""Long-generation bench: the ring KV policy against the unbounded drop
contract at a long horizon (the twin of ``run/long_gen_bench.py``).

* ``drop``: the decode region sized for the whole ``--new`` budget (bounded
  by the output-text keep rate when its predictor is on); memory grows
  with the horizon.
* ``ring``: both tiers capped at ``--window`` decode tokens; past the
  window each new token evicts the oldest decode entry
  (``dynamic.decode_step(kv_overflow="ring")``).

Each mode runs in a child process of its own (the allocator starts clean),
which prints a ``LONGGEN_RESULT <json>`` line: steady-state decode tok/s
over the whole horizon, the tiers' capacities, the mean post-tier length
after the decode, live GiB after the prefill and after the decode, and
``profiling.memory_report``'s keys (no ``programs_gb``: XLA's program
analysis has no PyTorch counterpart). The caches are sized as
``make_gen_cache(cfg, B, seq_len, new, decode_window=window if ring,
ring=ring)``; the ``new`` greedy steps are the ``DecodeRunner``'s captured
graph, replayed a step (on the CPU the same steps eagerly); the timed
decode follows a warm one and a second prefill, after ``synchronize``.

    python3 tools/long_gen_bench.py [--model 7b] [--batch 8] [--quant int8] \\
        [--text 64] [--new 2048] [--window 256] [--cache-dtype bfloat16] [--dense]
    python3 tools/long_gen_bench.py --model small --cpu --new 24 --window 8

It runs on the card unless ``--cpu`` is given, prints the card's name and
power limit, a line a mode, and the summary JSON as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import harness

TAG = "LONGGEN_RESULT"


def measure(args, params=None, tokens=None) -> dict:
    """One mode (``args.mode``) in this process, on ``params`` (default: the
    bench's random weights of ``args.model``). ``tokens``, if given,
    receives the timed decode's greedy tokens, one list a sample."""
    import numpy as np
    import torch

    from dynamic_llava_tpu_torch.eval.bench import (
        bench_generation_config, bf16_pixels, build_bench_params, build_inputs, sync)
    from dynamic_llava_tpu_torch.generation.generate import Generator
    from dynamic_llava_tpu_torch.profiling import GB, live_device_bytes, memory_report

    dev = harness.device(args)
    ring = args.mode == "ring"
    cfg = harness.model_config(args, dense=args.dense)
    if params is None:
        params = build_bench_params(cfg, args.quant, dev)
    plan, imgs = build_inputs(cfg, args.batch, args.text)
    imgs = bf16_pixels(imgs)
    gen = Generator(params, cfg, bench_generation_config(args.new, args.cache_dtype)._replace(
        kv_overflow="ring" if ring else "drop", kv_window=args.window if ring else None))
    if dev.type == "cuda":  # the peak of this run, not of the process
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        runner = gen.runner(plan, imgs, args.new, chunk=args.new)
        runner.load(gen.prefill_into(plan, imgs, runner.fresh_cache())[0], 0)
        sync(dev)
        live_after_prefill = live_device_bytes(dev)
        runner.run_chunk().tokens()  # warm (the capture), read on the host
        live_after_decode = live_device_bytes(dev)
        post_len = float(np.mean(runner.state.cache.post.length.cpu().numpy()))
        # a prefill rewrites the cache from slot 0 and resets its lengths
        runner.load(gen.prefill_into(plan, imgs, runner.state.cache)[0], 0)
        sync(dev)
        t0 = time.perf_counter()
        toks = runner.run_chunk().tokens()
        dt = time.perf_counter() - t0
    if tokens is not None:
        tokens.extend([[int(t) for t in toks[:, i]] for i in range(args.batch)])
    cache = runner.state.cache
    return {
        "mode": args.mode,
        "decode_tok_s": round(args.batch * args.new / dt, 2),
        "horizon_s": round(dt, 2),
        "pre_cache_capacity": int(cache.pre.max_len),
        "post_cache_capacity": int(cache.post.max_len),
        "post_len_after_decode": post_len,
        "live_after_prefill_gb": round(live_after_prefill / GB, 4),
        "live_after_decode_gb": round(live_after_decode / GB, 4),
        **memory_report(dev, model_params=params),
    }


def summarize(args, results: dict) -> dict:
    if not all("decode_tok_s" in results[m] for m in ("ring", "drop")):
        return {"metric": "longgen_incomplete", "detail": results}
    ring, drop = results["ring"], results["drop"]
    return {
        "metric": f"longgen_{args.model}_b{args.batch}_n{args.new}_w{args.window}",
        "ring_tok_s": ring["decode_tok_s"],
        "drop_tok_s": drop["decode_tok_s"],
        "ring_vs_drop": round(ring["decode_tok_s"] / drop["decode_tok_s"], 4),
        "post_capacity_ring": ring["post_cache_capacity"],
        "post_capacity_drop": drop["post_cache_capacity"],
        "pre_capacity_ring": ring["pre_cache_capacity"],
        "pre_capacity_drop": drop["pre_cache_capacity"],
        "detail": results,
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="7b")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--text", type=int, default=64)
    p.add_argument("--new", type=int, default=2048)
    p.add_argument("--window", type=int, default=256)
    p.add_argument("--quant", default="int8")
    p.add_argument("--cache-dtype", default="bfloat16")
    p.add_argument("--dense", action="store_true", help="predictors off (dense baseline)")
    p.add_argument("--mode", choices=["drop", "ring"], default=None,
                   help="(child) measure one mode in this process")
    p.add_argument("--timeout", type=float, default=3000.0)
    harness.add_run_flags(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.quant in ("", "none"):
        args.quant = None
    if args.mode is not None:
        print(f"{TAG} " + json.dumps(measure(args)), flush=True)
        return 0

    harness.print_card(args)
    results = {}
    for mode in ("ring", "drop"):
        cmd = [os.path.abspath(__file__), "--mode", mode]
        for k in ("model", "batch", "text", "new", "window", "quant", "cache_dtype"):
            cmd += ["--" + k.replace("_", "-"), str(getattr(args, k) or "none")]
        cmd += (["--dense"] if args.dense else []) + harness.run_flags(args)
        results[mode] = harness.run_child(cmd, TAG, args.timeout)
        print(json.dumps({mode: results[mode]}), flush=True)
    print(json.dumps(summarize(args, results)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
