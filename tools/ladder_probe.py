#!/usr/bin/env python3
"""Serving-ladder capacity probe: the largest batch that fits one card per
weight quantization x KV storage (the twin of ``run/ladder_probe.py``).

Each row, ``side:quant:cache_dtype:batch`` (quant / cache ``-`` = bf16), is
one bench side: ``eval.bench.bench_config`` (TTFT over repeated prefills,
a captured decode chunk, allocator memory) on the bench's random weights,
in a child process of its own (this tool with ``--row``), so that every
row starts on a clean allocator. A row whose child fails (on the card an
out-of-memory error: the fit boundary is the result) is recorded with
``error`` and the probe goes on; a row that no longer fits ``--budget-s``
is recorded as ``skipped``. Each row prints a ``LADDER_ROW <json>`` line;
the last line is ``{"ladder_probe": [...]}``.

``DEFAULT_ROWS`` keep the JAX plan's three compositions at 7B, text 64,
512 new tokens, resized for one 80 GB card by measurement: for each one
the largest row that fit and the smallest that ran out of memory, in four
runs of this tool on an NVIDIA H100 80GB HBM3 at 700.00 W (79.18 GiB to
the allocator; PERF.md, Findings, has the runs):

================================  ===========  ==================
composition                       largest fit  first out of memory
================================  ===========  ==================
sparse int8 + int8 KV             256          288
dense int8 + int8 KV              160          176
sparse int4 + fp8 KV              256          304
================================  ===========  ==================

The cache that ``make_gen_cache`` allocates a sample
(``kv_bytes_per_sample``) bounds none of them: the allocator's peak grew
0.220 / 0.385 / 0.218 GiB a sample there, about twice the cache.

    python3 tools/ladder_probe.py [--rows side:quant:cache:batch ...] [--model 7b] \\
        [--new-tokens 512] [--text-len 64] [--budget-s 5400]
    python3 tools/ladder_probe.py --model small --cpu --new-tokens 4 --rows sparse:int8:int8:2

It runs on the card unless ``--cpu`` is given and prints the card's name
and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import harness

TAG = "BENCH_RESULT"
CACHE_DTYPES = {"int8": "int8", "fp8": "float8_e4m3fn", "-": None,
                "bf16": None, "float8_e4m3fn": "float8_e4m3fn"}
DEFAULT_ROWS = [
    "sparse:int8:int8:256",
    "sparse:int8:int8:288",
    "dense:int8:int8:160",
    "dense:int8:int8:176",
    "sparse:int4:fp8:256",
    "sparse:int4:fp8:304",
]
MIN_ROW_S = 120.0  # a row's least time; less budget left skips it
MAX_ROW_S = 3400.0  # a row's longest time


def parse_row(s: str) -> dict:
    side, quant, cache, batch = s.split(":")
    quant = None if quant == "-" else quant
    return dict(side=side, quant=quant, cache_dtype=CACHE_DTYPES[cache], batch=int(batch))


def label(row: dict) -> str:
    return "{}:{}:{}:B{}".format(row["side"], row["quant"] or "bf16",
                                 row["cache_dtype"] or "bf16", row["batch"])


def kv_bytes_per_sample(cfg, cache_dtype, text_len: int, new_tokens: int) -> int:
    """Bytes of the KV cache that ``make_gen_cache`` allocates a sample of
    the bench's prompts at text ``text_len`` and ``new_tokens`` new tokens
    (made on the meta device: nothing is allocated)."""
    from dynamic_llava_tpu_torch.eval.bench import build_inputs
    from dynamic_llava_tpu_torch.generation.generate import CACHE_DTYPES as STORAGE
    from dynamic_llava_tpu_torch.models.dynamic import make_gen_cache

    plan, _ = build_inputs(cfg, 1, text_len)
    cache = make_gen_cache(cfg, 1, plan.seq_len, new_tokens,
                           STORAGE[cache_dtype or "bfloat16"], device="meta")
    return sum(t.numel() * t.element_size() for tier in cache for t in tier if t is not None)


def measure(args, params=None) -> dict:
    """Row ``args.row`` in this process: ``bench_config``'s record on
    ``params`` (default: the bench's random weights of the row)."""
    from dynamic_llava_tpu_torch.eval.bench import bench_config, build_bench_params

    row = parse_row(args.row)
    cfg = harness.model_config(args, dense=row["side"] == "dense")
    if params is None:
        params = build_bench_params(cfg, row["quant"], harness.device(args))
    return bench_config(params, cfg, batch=row["batch"], text_len=args.text_len,
                        new_tokens=args.new_tokens,
                        cache_dtype=row["cache_dtype"] or "bfloat16")


def child_row(args, s: str, timeout: float) -> dict:
    """Row ``s`` in a child process: its ``bench_config`` record, or
    ``{"error": ...}`` with the tail of the child's output."""
    cmd = [os.path.abspath(__file__), "--row", s, "--model", args.model,
           "--new-tokens", args.new_tokens, "--text-len", args.text_len]
    return harness.run_child(cmd + harness.run_flags(args), TAG, timeout)


def record(name: str, r: dict) -> dict:
    return {"row": name, "decode_tok_s": r["decode_tok_s"],
            "ttft_ms": r.get("ttft_device_ms", r["ttft_ms"]),
            "live_gb": r.get("live_after_decode_gb"),
            "peak_minus_model_gb": r.get("peak_minus_model_gb")}


def probe(args, run_row=child_row) -> list:
    """Every row of ``args.rows`` in turn through ``run_row(args, row,
    timeout)``, within ``args.budget_s`` seconds: a row a record, printed
    as a ``LADDER_ROW`` line."""
    deadline = time.time() + args.budget_s
    results = []
    for s in args.rows:
        name = label(parse_row(s))
        timeout = min(deadline - time.time() - 20, MAX_ROW_S)
        if timeout < MIN_ROW_S:  # unmeasured, not a failed fit
            rec = {"row": name, "skipped": "wall-clock budget exhausted"}
        else:
            r = run_row(args, s, timeout)
            if "decode_tok_s" in r:
                rec = record(name, r)
            elif timeout < MAX_ROW_S and r["error"].startswith("timed out"):
                # the closing budget cut the row, not the row itself
                rec = {"row": name, "skipped": f"wall-clock budget expired mid-row "
                                               f"({timeout:.0f}s)"}
            else:  # out of memory, or a failure: the boundary is data
                rec = {"row": name, "error": r["error"][-400:]}
        results.append(rec)
        print("LADDER_ROW " + json.dumps(rec), flush=True)
    return results


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--rows", nargs="*", default=DEFAULT_ROWS,
                   help="side:quant:cache_dtype:batch")
    p.add_argument("--model", default="7b")
    p.add_argument("--new-tokens", type=int, default=512)
    p.add_argument("--text-len", type=int, default=64)
    p.add_argument("--budget-s", type=float, default=5400.0)
    p.add_argument("--row", default=None, help="(child) measure one row in this process")
    harness.add_run_flags(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.row is not None:
        try:
            r = measure(args)
        except Exception as e:  # noqa: BLE001
            if type(e).__name__ != "OutOfMemoryError":
                raise
            # the message's head (the bytes asked for, the card's capacity)
            # ends the output, where the probe reads the row's error
            sys.exit(f"ladder row {args.row}: {str(e)[:300]}")
        print(f"{TAG} " + json.dumps(r), flush=True)
        return 0
    harness.print_card(args)
    print(json.dumps({"ladder_probe": probe(args)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
