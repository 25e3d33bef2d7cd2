#!/usr/bin/env python3
"""Phase 5j of ``chip_smoke.py`` alone, in a fresh process.

    python3 tools/probe_harnesses.py

It builds the kernels, makes the bench's LLaVA-1.5-7B weights with an
int8 decoder directly (``eval.bench.build_bench_params``, seed 0), cuts the
decoder to its first ``chip_smoke.HARNESS_DEPTH`` layers (views) and runs
``chip_smoke.harnesses`` on them: the five measurement harnesses' twins in
``tools/`` at the phase's horizons, their holds, and the wrapper calls. It
prints the card's name and power limit, the phase's lines, and the
``harnesses`` record as the last line. It needs one 80 GB card (~2 min
with the build).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_harnesses.py: torch.cuda.is_available() is False")
    from dynamic_llava_tpu_torch import kernels
    from dynamic_llava_tpu_torch.eval.bench import bench_cfg, build_bench_params

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    kernels.load_library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = bench_cfg("7b")
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_hidden_layers=cs.HARNESS_DEPTH))
    params = build_bench_params(cfg, "int8", "cuda")
    torch.cuda.synchronize()
    out = cs.harnesses(torch, params, cs.HARNESS_DEPTH)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
