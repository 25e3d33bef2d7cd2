#!/usr/bin/env python3
"""Where a train step's time goes in the PyTorch/CUDA port.

    python3 tools/profile_train.py [--depth 32]

Run from the root of a checkout on one CUDA card with 80 GB. At
LLaVA-1.5-7B width (random bf16 weights from seed 0, ``--depth`` decoder
layers), on the batch ``chip_smoke.py`` trains on (B=4, one 336x336 image
and 1088 text tokens each, fused S = 1663), for the sparse configuration
and then the dense stage on the same weights, it

* takes two warm-up steps through ``Trainer.train``, then times two steps
  on the host clock after ``synchronize`` (the step wall), with the
  optimizer's share timed apart (a ``synchronize`` before and after
  ``GroupedAdamW.update``);
* records one more step with ``torch.profiler`` (CPU and CUDA activities)
  and sums the device time of every kernel, in buckets by kernel name: K1
  (``flash_fwd_*``: the tensor-core kernel for bf16, the fp32 one), K3
  (``flash_bwd_*``: the delta, dq and dkv kernels), K4 (``flash_policy_fwd_*``:
  the tensor-core kernel for bf16, the fp32 one; ``policy_vsum_kernel``), fp32 GEMM (``sgemm``, ``simt``, ``f32f32``, ``ffma`` names: the
  blockwise recompute behind K4's backward and the predictors' plain
  attention), GEMM (the other ``gemm``, ``nvjet``, ``cutlass``, ``xmma``
  names: the bf16 linears) and other (elementwise, reductions, copies,
  the optimizer). Idle share = 1 - device busy / step wall.

It prints the card's name and power limit, one line per mode with its
largest kernels, and one JSON object as the last line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SEED, WARM, TIMED = 0, 2, 2
# bucket -> kernel-name fragments; the port's kernels are matched first
BUCKETS = (
    ("K1", ("flash_fwd_",)),
    ("K3", ("flash_bwd_",)),
    ("K4", ("flash_policy_fwd_", "policy_vsum_kernel")),
    ("fp32 GEMM", ("sgemm", "simt", "f32f32", "ffma")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "splitK")),
)


def bucket(name: str) -> str:
    for label, parts in BUCKETS:
        if any(p in name for p in parts):
            return label
    return "other"


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def profile(torch, params, cfg, mode, batch):
    """The measurements of one mode (see the module docstring)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from dynamic_llava_tpu_torch.train.trainer import Trainer, TrainerConfig

    with tempfile.TemporaryDirectory() as out_dir:
        tc = TrainerConfig(output_dir=out_dir, num_train_steps=100, warmup_ratio=0.01,
                           logging_steps=1, save_steps=0, report_to="none", seed=SEED)
        trainer = Trainer(cfg, params, tc)
        opt_s = []
        update = trainer.optimizer.update

        def timed_update(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = update(*args)
            torch.cuda.synchronize()
            opt_s.append(time.perf_counter() - t0)
            return out

        trainer.optimizer.update = timed_update
        trainer.train([batch] * WARM)
        opt_s.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.train([batch] * TIMED)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / TIMED
        opt_ms = sum(opt_s) * 1e3 / len(opt_s)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            metrics = trainer.train([batch])
            torch.cuda.synchronize()
        del trainer
    per_bucket, per_kernel, launches = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            per_bucket[bucket(e.name)] += ms
            per_kernel[e.name] += ms
            launches[e.name] += 1
    busy = sum(per_bucket.values())
    require(busy > 0, f"{mode}: the profiler saw no device time")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    b, s = batch[0].token_ids.shape
    res = dict(depth=cfg.text.num_hidden_layers, step_wall_ms=step_ms, optimizer_wall_ms=opt_ms,
               tok_s=b * s / step_ms * 1e3, peak_gib=peak, device_busy_ms=busy,
               idle_share=max(0.0, 1 - busy / step_ms), kernel_launches=sum(launches.values()),
               buckets_ms=dict(per_bucket), loss=metrics["loss"],
               top=[dict(name=n, ms=ms, launches=launches[n]) for n, ms in top])
    print(f"train {mode} depth {res['depth']} B={b} S={s}: step wall {step_ms:.1f} ms "
          f"(optimizer {opt_ms:.1f} ms), {res['tok_s']:.1f} tok/s, peak {peak:.2f} GiB; "
          f"profiled step: device busy {busy:.1f} ms, idle share {res['idle_share']:.3f}, "
          f"{res['kernel_launches']} kernel launches; ms by bucket "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(per_bucket.items())), flush=True)
    for t in res["top"]:
        print(f"    {t['name'][:110]} {t['ms']:.1f} ms, {t['launches']} launches", flush=True)
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--depth", type=int, default=32, help="decoder layers (width is fixed)")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_train.py: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke
    from dynamic_llava_tpu_torch import kernels
    from dynamic_llava_tpu_torch.config import DENSE_SPARSE_CONFIG, LlavaConfig
    from dynamic_llava_tpu_torch.weights import init_llava_params

    kernels.load_library()
    base, dev = LlavaConfig(), torch.device("cuda")
    sparse = dataclasses.replace(
        base, text=dataclasses.replace(base.text, num_hidden_layers=args.depth))
    dense = dataclasses.replace(sparse, sparse=DENSE_SPARSE_CONFIG)
    params = init_llava_params(sparse, torch.Generator(device=dev).manual_seed(SEED), dev,
                               torch.bfloat16)
    batch = chip_smoke.train_batch(sparse, chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_TEXT_LEN)
    out = {"sparse": profile(torch, params, sparse, "sparse", batch),
           "dense": profile(torch, params, dense, "dense", batch)}
    print(json.dumps({"device": smi, "train_b4_s1663": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
