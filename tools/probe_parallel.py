#!/usr/bin/env python3
"""Phase 9e of ``chip_smoke.py`` alone, in a fresh process: the parallel
layer (``dynamic_llava_tpu_torch/parallel``) on a world-size-1 NCCL group
and a ``(1, 1, 1, 1)`` mesh at LLaVA-1.5-7B width, 8 of 32 layers.

    python3 tools/probe_parallel.py

It builds the kernels and runs ``chip_smoke.parallel_phase``: the sharded
and the pipelined train step (1 stage, 2 microbatches) against the
unsharded one (B=4, S=1663, bf16, the same weights and noise), then sharded
prefill, decode steps and speculative rounds at B=2 against the unsharded
calls, with K1 / K3 / K4 / K2 / K2-M counted on the sharded paths. The last
line is the phase's JSON (the ``parallel`` line of ``chip_smoke.py``). It
needs one 80 GB card (~1.5 min with the build).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    cs.use_kineto_config()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_parallel.py: torch.cuda.is_available() is False")
    from dynamic_llava_tpu_torch import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.load_library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    result = cs.parallel_phase(torch)
    print(f"phase 9e {time.perf_counter() - t0:.1f} s")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
