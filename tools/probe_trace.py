#!/usr/bin/env python3
"""Repeat a serving mode of ``chip_smoke.py`` with its first call traced and
report whether the profiler counted every launch the launch counter did.

    KINETO_LOG_LEVEL=1 python3 tools/probe_trace.py --runs 5 2>&1 | \\
        grep -E "GPU records|Max GPU buffer|run [0-9]|fails"

(add ``--default-cap`` to keep kineto's default cap on a trace's records)

``--mode ring`` (the default) is the ring overflow at LLaVA-1.5-7B width on
an int4 decoder (random weights from a seed) with the fused MLP and an int8
KV cache: B=8, 256 new tokens, whose ``Generator.generate`` calls make the
largest traces of ``chip_smoke.py``; ``--mode bf16`` is phase 5's sparse and
dense bf16 serving (B=8, 64 new tokens). Each run is ``chip_smoke.serve`` on
the mode (two counted calls a mode, each held to an eager loop's wrapper
calls; the first mode's first call also traced, and the trace's launches held
equal to the counter's: ``chip_launches.counted_against_trace``), so a run
fails where a trace lost launches. kineto reads ``chip_smoke.py``'s config (its
cap on one trace's records raised to 1 GB) unless ``--default-cap``. With
``KINETO_LOG_LEVEL=1`` kineto writes each trace's record volume and its cap
to standard error. It needs one card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--mode", choices=("ring", "bf16"), default="ring")
    ap.add_argument("--default-cap", action="store_true",
                    help="kineto's default cap on a trace's records (128 MB)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    if not args.default_cap:
        cs.use_kineto_config()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_trace.py: torch.cuda.is_available() is False")
    from dynamic_llava_tpu_torch.config import DENSE_SPARSE_CONFIG, LlavaConfig
    from dynamic_llava_tpu_torch.eval.bench import build_bench_params
    from dynamic_llava_tpu_torch.ops import quant_matmul as qm
    from dynamic_llava_tpu_torch.ops.decode_attention import decode_attention
    from dynamic_llava_tpu_torch.ops.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = LlavaConfig()
    params = build_bench_params(cfg, None if args.mode == "bf16" else "int4", dev)
    counters = {"flash_attention_fwd": flash_attention,
                "decode_attention_appended": decode_attention,
                "q8_gemv": qm.q8_gemv, "q8_gemv_group": qm.q8_gemv_group,
                "q4_gemv": qm.q4_gemv, "q4_gemv_group": qm.q4_gemv_group,
                "q4_mlp": qm.q4_mlp}
    need = ("flash_attention_fwd", "decode_attention_appended")
    kw = {}
    if args.mode == "bf16":
        modes = [("sparse", cfg), ("dense", LlavaConfig(sparse=DENSE_SPARSE_CONFIG))]
    else:
        need += ("q4_gemv", "q4_gemv_group", "q4_mlp")
        ring = dict(cache_dtype="int8", kv_overflow="ring", kv_window=64)
        modes = [("ring", cfg, dict(fused=True, gen=ring))]
        kw = dict(max_new=256)
    fails = 0
    for i in range(args.runs):
        t0 = time.perf_counter()
        try:
            cs.serve(torch, params, modes, counters, need, args.mode, hold_trace=True, **kw)
            print(f"run {i}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
        except RuntimeError as e:
            fails += 1
            print(f"run {i}: FAIL {str(e)[:400]}", flush=True)
    print(f"fails {fails} of {args.runs}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
