#!/usr/bin/env python3
"""Phase 9d of ``chip_smoke.py`` alone, in a fresh process: the training CLI
(``dynamic_llava_tpu_torch.train.train_sparse``) at LLaVA-1.5-7B width.

    python3 tools/probe_train_cli.py

It builds the kernels and runs ``chip_smoke.train_cli``: a JSON set of v1
conversations (12 records with a PNG image of mixed aspect ratio, 4
text-only, ~1.6k fused tokens each) and a word-level tokenizer written to
a temporary directory, then ``train(argv)`` with ``--model_size 7b
--per_device_train_batch_size 4 --max_steps 3`` in this process (K1 / K3 /
K4 launches held to phase 9's sparse step), then the CLI's final save
(~40 GiB; the room is checked first, the directory removed after). In a
fresh process the tokenizer's first load also imports ``transformers``,
timed apart. The last line is the phase's JSON (step times, fused lengths,
peak, save seconds and bytes, whether the native image path ran). It needs
one 80 GB card and ~45 GiB free in the temporary directory (~3 min with the
build).
"""

from __future__ import annotations

import json
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
        raise SystemExit("probe_train_cli.py: torch.cuda.is_available() is False")
    from dynamic_llava_tpu_torch import kernels
    from dynamic_llava_tpu_torch.config import LlavaConfig
    from dynamic_llava_tpu_torch.weights import init_llava_params, param_bytes

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.load_library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    cfg = LlavaConfig()
    # the room the final save needs, from the weights the CLI will make
    params = init_llava_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev,
                               torch.bfloat16)
    need = 3 * param_bytes(params)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    result = cs.train_cli(torch, cs.train_launches(cfg)["sparse"], need)
    print(f"phase 9d {time.perf_counter() - t0:.1f} s")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
