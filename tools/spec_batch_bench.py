#!/usr/bin/env python3
"""Speculative decoding at serving batch sizes: plain against ``spec_k``
at each batch of ``--batches`` (the twin of ``run/spec_batch_bench.py``).

A verify pass reads the weights about once whatever the batch, so at
weight-bound batches accepted drafts are free throughput; at cache-bound
batches the k extra KV reads a row eat the margin. This table measures
where that crossover sits.

Each side is a child process of its own (this tool with ``--side-batch``:
the allocator starts clean), running the bench core on the bench's
random weights: ``eval.bench.bench_config`` (plain) or
``bench_spec_config`` (``generate_speculative_device``: in-graph prompt
lookup). It prints a ``BENCH_RESULT <json>`` line. Random weights emit
repetitive text, which flatters prompt lookup: ``tokens_per_round`` stands
beside every tok/s; ``tools/spec_bench.py`` holds the oracle ceiling.

    python3 tools/spec_batch_bench.py [--model 7b] [--quant int8] [--new 256] [--k 7] \\
        [--batches 8,24] [--cache-dtype bfloat16]
    python3 tools/spec_batch_bench.py --model small --cpu --new 8 --k 3 --batches 2

It runs on the card unless ``--cpu`` is given, prints the card's name and
power limit, a line a side, and the summary JSON as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import harness

TAG = "BENCH_RESULT"


def measure(args, params=None) -> dict:
    """One side in this process: batch ``args.side_batch``, plain or with
    ``args.side_spec_k`` drafts, on ``params`` (default: the bench's random
    weights of ``args.model``)."""
    from dynamic_llava_tpu_torch.eval.bench import (
        bench_config, bench_spec_config, build_bench_params)

    dev = harness.device(args)
    cfg = harness.model_config(args)
    if params is None:
        params = build_bench_params(cfg, args.quant, dev)
    kw = dict(batch=args.side_batch, text_len=args.text, new_tokens=args.new,
              cache_dtype=args.cache_dtype)
    if args.side_spec_k:
        return bench_spec_config(params, cfg, spec_k=args.side_spec_k, **kw)
    return bench_config(params, cfg, **kw)


def run_side(args, batch: int, spec_k: int) -> dict:
    cmd = [os.path.abspath(__file__), "--side-batch", batch, "--side-spec-k", spec_k]
    for key in ("model", "text", "new", "quant", "cache_dtype"):
        cmd += ["--" + key.replace("_", "-"), getattr(args, key) or "none"]
    return harness.run_child(cmd + harness.run_flags(args), TAG, args.timeout)


def summarize(args, rows) -> dict:
    return {
        "metric": f"spec_x_batch_{args.model}" + (f"_{args.quant}" if args.quant else "")
                  + f"_k{args.k}",
        "new_tokens": args.new,
        "rows": [
            {
                "batch": r["batch"],
                "plain_tok_s": round(r["plain"].get("decode_tok_s", 0), 1),
                "spec_tok_s": round(r["spec"].get("decode_tok_s", 0), 1),
                "speedup": r.get("speedup"),
                "tokens_per_round": r["spec"].get("tokens_per_round"),
            }
            for r in rows
        ],
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="7b")
    p.add_argument("--text", type=int, default=64)
    p.add_argument("--new", type=int, default=256)
    p.add_argument("--k", type=int, default=7)
    p.add_argument("--quant", default="int8")
    p.add_argument("--cache-dtype", dest="cache_dtype", default="bfloat16")
    p.add_argument("--batches", default="8,24")
    p.add_argument("--timeout", type=float, default=2400.0)
    p.add_argument("--side-batch", type=int, default=None,
                   help="(child) measure one side at this batch in this process")
    p.add_argument("--side-spec-k", type=int, default=0,
                   help="(child) the side's drafts a round (0: plain)")
    harness.add_run_flags(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.quant in ("", "none"):
        args.quant = None
    if args.side_batch is not None:
        print(f"{TAG} " + json.dumps(measure(args)), flush=True)
        return 0

    harness.print_card(args)
    rows = []
    for batch in [int(b) for b in args.batches.split(",")]:
        plain = run_side(args, batch, 0)
        print(json.dumps({"batch": batch, "arm": "plain", **plain}), flush=True)
        spec = run_side(args, batch, args.k)
        print(json.dumps({"batch": batch, "arm": f"spec_k{args.k}", **spec}), flush=True)
        row = {"batch": batch, "plain": plain, "spec": spec}
        if "decode_tok_s" in plain and "decode_tok_s" in spec:
            row["speedup"] = round(spec["decode_tok_s"] / plain["decode_tok_s"], 3)
        rows.append(row)
    print(json.dumps(summarize(args, rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
