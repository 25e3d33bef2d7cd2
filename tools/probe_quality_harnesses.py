#!/usr/bin/env python3
"""Phases 4c and 5i of ``chip_smoke.py`` alone, in a fresh process, or the
production-boundary harness's full default table on the card.

    python3 tools/probe_quality_harnesses.py [--full-table]

It builds the kernels, then runs ``chip_smoke.deep_quality`` (phase 4c: the
deep harness's pieces held card against CPU, then ``run_all`` at the
phase's cut step counts; with ``--full-table`` at the harness's default
1500 dense + 600 sparse steps, its rows, seconds and K1 / K3 / K4 / K2
wrapper calls printed as the phase prints them) and
``chip_smoke.weights_drop`` (phase 5i: the weights-drop twin on its fixture,
card against CPU, then on a checkpoint of LLaVA-1.5-7B width on
``CKPT_DEPTH`` of 32 layers, random bf16 weights from the script's seed,
exported to a temporary directory with three 400x300 images, as phase 5e
makes them). The last line is a JSON object of the phases' dicts. It needs
one 80 GB card (~2 min with the build; ~4 min more with ``--full-table``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-table", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    cs.use_kineto_config()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_quality_harnesses.py: torch.cuda.is_available() is False")
    from dynamic_llava_tpu_torch import kernels
    from dynamic_llava_tpu_torch.config import LlavaConfig
    from dynamic_llava_tpu_torch.models.export import export_hf_checkpoint
    from dynamic_llava_tpu_torch.run import deep_sparse_quality as dq
    from dynamic_llava_tpu_torch.weights import init_llava_params

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.load_library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    out = {}

    sizes = None
    if args.full_table:  # the harness's default step counts
        full = dq.parser().parse_args([])
        sizes = dict(dense_steps=full.dense_steps, steps=full.steps)
    out["deep_quality"] = cs.deep_quality(torch, sizes=sizes)

    from PIL import Image

    cfg = LlavaConfig()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                            num_hidden_layers=cs.CKPT_DEPTH))
    dev = torch.device("cuda")
    params = init_llava_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev,
                               torch.bfloat16)
    with tempfile.TemporaryDirectory(prefix="probe_wdrop_") as root:
        path = os.path.join(root, cs.CKPT_NAME)
        t0 = time.perf_counter()
        export_hf_checkpoint(params, cfg, path)
        print(f"export of {cs.CKPT_DEPTH} layers {time.perf_counter() - t0:.1f} s", flush=True)
        del params
        torch.cuda.empty_cache()
        rng = np.random.default_rng(cs.SEED + 7)
        names = [f"q{i}.png" for i in range(cs.CKPT_QUESTIONS)]
        for name in names:
            Image.fromarray(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)).save(
                os.path.join(root, name))
        out["weights_drop"] = cs.weights_drop(torch, path, root, names)

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
