#!/usr/bin/env python3
"""Where a decode step's time goes in the PyTorch/CUDA port, per weight kind.

    python3 tools/profile_decode.py

Run from the root of a checkout on one CUDA card (about 25 GB of device
memory). At LLaVA-1.5-7B width (random weights from seed 0), sparse, it
plans the batch ``chip_smoke.py`` serves (8 requests, one 336x336 image and
60 text tokens each) and, for bf16 weights, the same weights quantized in
place to int8, an int4 decoder made directly, that decoder with the fused
MLP switched on (K9, ``DYNAMIC_LLAVA_Q4_MLP=1``), fused with the KV cache
stored in scaled int8, and the two-kernel int4 MLP once more, so that the
fused and two-kernel modes alternate (and, with the bf16 weights, once more
for the dense configuration, whose prefill keeps all 576 image tokens in
every layer):

* times the prefill (``Generator.prefill_from_plan``) three times on the
  host clock after ``synchronize`` and keeps the middle one, then records
  one more prefill with ``torch.profiler`` and sums its device time in the
  same buckets as below;
* after 4 warm-up decode steps, times 16 decode steps (greedy sample +
  ``dynamic.decode_step``) on the host clock: the step wall;
* records 16 more steps with ``torch.profiler`` (CPU and CUDA activities)
  and sums the device time of every kernel, in buckets by kernel name:
  K5-K8 (``gemv_tc_kernel`` / ``gemv_fma_kernel``), K9 (``q4_mlp_kernel``),
  K2 (``decode_kernel``), K1 (``flash_fwd_*``), cuBLAS (``gemm``, ``gemv``, ``nvjet``,
  ``cutlass``, ``xmma``, ``splitK`` names that are not the port's own) and
  other. Idle share = 1 - device busy / step wall.

It prints the card's name and power limit, one line per weight kind with
its largest kernels, and one JSON object as the last line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SEED, B, N_TEXT, MAX_NEW = 0, 8, 60, 64
WARM, STEPS = 4, 16
# bucket -> kernel-name fragments; the port's kernels are matched first
BUCKETS = (
    ("K5-K8", ("gemv_tc_kernel", "gemv_fma_kernel")),
    ("K9", ("q4_mlp_kernel",)),
    ("K2", ("decode_kernel",)),
    ("K1", ("flash_fwd_",)),
    ("cuBLAS", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitK")),
)


def bucket(name: str) -> str:
    for label, parts in BUCKETS:
        if any(p in name for p in parts):
            return label
    return "other"


def sum_device_ms(prof, per: int = 1):
    """``(ms by bucket, ms by kernel name, launches by kernel name)`` of the
    device activity a profiler recorded, times divided by ``per``."""
    from torch.autograd import DeviceType

    per_bucket, per_kernel, launches = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3 / per
            per_bucket[bucket(e.name)] += ms
            per_kernel[e.name] += ms
            launches[e.name] += 1
    return per_bucket, per_kernel, launches


def profile(torch, params, cfg, kind, cache_dtype="bfloat16", fused=False):
    """The measurements of one weight kind (see the module docstring), with
    the KV cache stored in ``cache_dtype`` and the fused int4 MLP on or off."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.models import dynamic
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch

    rng = np.random.default_rng(SEED)
    vocab, size = cfg.text.vocab_size, cfg.vision.image_size
    ids = [np.concatenate([rng.integers(3, vocab, N_TEXT // 2), [IMAGE_TOKEN_INDEX],
                           rng.integers(3, vocab, N_TEXT - N_TEXT // 2)])
           for _ in range(B)]
    pix = rng.standard_normal((B, size, size, 3), dtype=np.float32)
    gc = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1, cache_dtype=cache_dtype)
    os.environ.pop("DYNAMIC_LLAVA_Q4_MLP", None)
    if fused:
        os.environ["DYNAMIC_LLAVA_Q4_MLP"] = "1"
    plan = plan_batch(ids, cfg.num_image_tokens, pad_multiple=gc.pad_multiple)
    gen = Generator(params, cfg, gc)

    def steps(state, n):
        for _ in range(n):
            tok = torch.argmax(state.last_logits, dim=-1)
            state = dynamic.decode_step(params, cfg, tok, state)
        return state

    with torch.inference_mode():
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = gen.prefill_from_plan(plan, pix, MAX_NEW)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pre:
            state, _ = gen.prefill_from_plan(plan, pix, MAX_NEW)
            torch.cuda.synchronize()
        state = steps(state, WARM)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = steps(state, STEPS)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / STEPS
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state = steps(state, STEPS)
            torch.cuda.synchronize()
    os.environ.pop("DYNAMIC_LLAVA_Q4_MLP", None)
    per_bucket, per_kernel, launches = sum_device_ms(prof, STEPS)
    pre_bucket = sum_device_ms(pre)[0]
    busy = sum(per_bucket.values())
    require(busy > 0, f"{kind}: the profiler saw no device time")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    res = dict(prefill_wall_ms=statistics.median(walls) * 1e3, step_wall_ms=step_ms,
               device_busy_ms=busy, idle_share=max(0.0, 1 - busy / step_ms),
               buckets_ms=dict(per_bucket), prefill_device_ms=sum(pre_bucket.values()),
               prefill_buckets_ms=dict(pre_bucket),
               top=[dict(name=n, ms=ms, launches_per_step=launches[n] / STEPS)
                    for n, ms in top])
    print(f"{kind} B={B}: prefill wall {res['prefill_wall_ms']:.3f} ms, profiled prefill "
          f"device busy {res['prefill_device_ms']:.3f} ms ("
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(pre_bucket.items())) + "); decode "
          f"step wall {step_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{res['idle_share']:.3f}; per step ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(per_bucket.items())), flush=True)
    for t in res["top"]:
        print(f"    {t['name'][:100]} {t['ms']:.3f} ms/step, "
              f"{t['launches_per_step']:g} launches/step", flush=True)
    return res


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_decode.py: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    from dynamic_llava_tpu_torch import kernels
    from dynamic_llava_tpu_torch.config import DENSE_SPARSE_CONFIG, LlavaConfig
    from dynamic_llava_tpu_torch.ops.quant import (
        init_quantized_llama_params, quantize_llm_params)
    from dynamic_llava_tpu_torch.weights import init_llava_params

    kernels.load_library()
    cfg, dev = LlavaConfig(), torch.device("cuda")
    params = init_llava_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                               torch.bfloat16)
    out = {"bf16": profile(torch, params, cfg, "bf16"),
           "bf16 dense": profile(torch, params, LlavaConfig(sparse=DENSE_SPARSE_CONFIG),
                                 "bf16 dense")}
    quantize_llm_params(params, bits=8)
    out["int8"] = profile(torch, params, cfg, "int8")
    del params["llm"]
    torch.cuda.empty_cache()
    params["llm"] = init_quantized_llama_params(
        cfg.text, torch.Generator(device=dev).manual_seed(SEED), dev, bits=4)
    # two-kernel, fused, fused, two-kernel: the host's pace drifts within a call
    out["int4"] = profile(torch, params, cfg, "int4")
    out["int4 fused MLP"] = profile(torch, params, cfg, "int4 fused MLP", fused=True)
    out["int4 fused MLP int8 KV"] = profile(torch, params, cfg, "int4 fused MLP int8 KV",
                                            cache_dtype="int8", fused=True)
    out["int4, again"] = profile(torch, params, cfg, "int4, again")
    print(json.dumps({"device": smi, "b8": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
