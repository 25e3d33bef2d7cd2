#!/usr/bin/env python3
"""Run the port's quality gates over seeds, widths and step counts, one JSON
line a run (the gate, the width, the seed, the step multiplier, the
seconds, the thresholds that failed, every arm's row and the gaps).

    python3 tools/gate_sweep.py --device cpu --threads 1 --gates vision text \\
        --widths jax hd64 --seeds 0 1 2 --mults 1 > sweep.jsonl

``jax`` is the JAX tests' width (text hidden 64 in 4 heads of 16, a tower
of hidden 32 in 2 heads), which ``chip_smoke.py`` phase 4b and the slow
tests run; ``hd64`` is the smallest width of 4 text heads that the
attention kernels take without padding (head_dim 64: text hidden 256, a
tower of hidden 128 in 2 heads), where ROADMAP C20's rows were measured.
``--threads`` fixes torch's CPU threads (the CPU's sums, and so a chaotic
training's outcome, depend on it).
A multiplier scales both training stages' step counts (the JAX tests':
vision 150 + 150, text 300 dense + 400 sparse). The harnesses' own JSON
lines go to standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WIDTHS = {"jax": dict(hidden=64),
          "hd64": dict(hidden=256, heads=4, vision_hidden=128, vision_heads=2)}


def run(gate: str, width: str, seed: int, mult: float, device: str) -> dict:
    from dynamic_llava_tpu_torch.run import sparse_quality as sq
    from dynamic_llava_tpu_torch.run import text_sparse_quality as tq

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        if gate == "vision":
            steps = int(150 * mult)
            rows, gaps = sq.run_all(steps=steps, pairs=32, holdout=32, layers=3,
                                    dense_steps=steps, sparse_layer=0, seed=seed,
                                    device=device, **WIDTHS[width])
            fails = sq.gate_failures(rows, gaps)
        else:
            rows, gaps = tq.run_all(steps=int(400 * mult), batch=32, holdout=32, layers=3, k=2,
                                    sparse_layer=0, seed=seed, dense_steps=int(300 * mult),
                                    predictor_lr=6e-3, device=device, **WIDTHS[width])
            fails = tq.gate_failures(rows, gaps)
    return {"gate": gate, "width": width, "seed": seed, "mult": mult,
            "seconds": round(time.perf_counter() - t0, 1), "fails": fails, "rows": rows,
            "gaps": gaps}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--gates", nargs="+", default=["vision", "text"])
    ap.add_argument("--widths", nargs="+", default=["jax"], choices=sorted(WIDTHS))
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--mults", nargs="+", type=float, default=[1.0])
    ap.add_argument("--threads", type=int, default=0, help="torch CPU threads (0: torch's default)")
    args = ap.parse_args(argv)
    if args.threads:
        import torch

        torch.set_num_threads(args.threads)
    for gate in args.gates:
        for width in args.widths:
            for mult in args.mults:
                for seed in args.seeds:
                    print(json.dumps(run(gate, width, seed, mult, args.device)), flush=True)


if __name__ == "__main__":
    main()
