#!/usr/bin/env python3
"""Phase 5g of ``chip_smoke.py`` alone, in a fresh process: the
generation-quality probes and the bench core at LLaVA-1.5-7B width.

    python3 tools/probe_ppl_tools.py

It builds the kernels, makes the random bf16 7B weights of phase 5 from
the same seed, exports them as phase 5e does (``export_hf_checkpoint`` to
a temporary directory, removed at the end), keeps them on the card (the
bench core runs on them) and runs ``chip_smoke.ppl_tools`` on that
checkpoint. The last two lines are the phase's ``ppl_tools`` and
``bench_core`` JSON. It needs one 80 GB card and 15 GB free in the
temporary directory (~3 min with the build).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_ppl_tools.py: torch.cuda.is_available() is False")
    from dynamic_llava_tpu_torch import kernels
    from dynamic_llava_tpu_torch.config import LlavaConfig
    from dynamic_llava_tpu_torch.models.export import export_hf_checkpoint
    from dynamic_llava_tpu_torch.weights import init_llava_params

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.load_library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    cfg = LlavaConfig()
    params = init_llava_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev,
                               torch.bfloat16)
    with tempfile.TemporaryDirectory(prefix="probe_ppl_tools_") as root:
        path = os.path.join(root, cs.CKPT_NAME)
        t0 = time.perf_counter()
        export_hf_checkpoint(params, cfg, path)
        print(f"export {time.perf_counter() - t0:.1f} s", flush=True)
        tools, core = cs.ppl_tools(torch, path, params, cfg)
    print("ppl_tools " + json.dumps(tools))
    print("bench_core " + json.dumps(core))
    return 0


if __name__ == "__main__":
    sys.exit(main())
