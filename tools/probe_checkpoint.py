#!/usr/bin/env python3
"""Phase 5e of ``chip_smoke.py`` alone, in a fresh process: the checkpoint
round trip and the entry points at LLaVA-1.5-7B width.

    python3 tools/probe_checkpoint.py

It builds the kernels, makes the random bf16 7B weights of phase 5 from
the same seed, takes phase 5's greedy sparse tokens (B=8, 64 tokens) as the
reference, and runs ``chip_smoke.checkpoint``: export to a temporary
directory, ``load_pretrained_model`` onto the card (leaves and config
checked), generate, two rounds of the chat CLI's loop, the VQA CLI plain
and with ``--spec_k 4`` on an fp32 load. The last line is the phase's JSON
(seconds, host and device peaks, launches). In a fresh process the first
load also imports ``transformers`` for the tokenizer's try, which
``chip_smoke.py`` times apart. It needs one 80 GB card and 15 GB free in
the temporary directory (~2.5 min with the build).
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
        raise SystemExit("probe_checkpoint.py: torch.cuda.is_available() is False")
    from dynamic_llava_tpu_torch import kernels
    from dynamic_llava_tpu_torch.config import LlavaConfig
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.weights import init_llava_params

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.load_library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    cfg = LlavaConfig()
    params = init_llava_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev,
                               torch.bfloat16)
    ids, pix = cs.serving_batch(cfg, 8, 60)
    want = Generator(params, cfg, GenerationConfig(
        max_new_tokens=64, temperature=0.0, eos_token_id=-1)).generate(ids, pix)
    t0 = time.perf_counter()
    result = cs.checkpoint(torch, params, cfg, want)
    print(f"phase 5e {time.perf_counter() - t0:.1f} s")
    print(json.dumps({k: v for k, v in result.items() if k != "vqa_answers"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
