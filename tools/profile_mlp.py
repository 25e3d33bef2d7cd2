#!/usr/bin/env python3
"""Where the fused int4 MLP's (K9) time goes, phase by phase.

    python3 tools/profile_mlp.py [--slices 0,2,7]

Run from the root of a checkout on one CUDA card. For each entry of
``--slices`` it copies ``dynamic_llava_tpu_torch/csrc`` into a directory of
its own under ``dynamic_llava_tpu_torch/_build/`` (git-ignored), with
``%globaltimer`` stamps written into ``quant_mlp.cu`` (each block's start,
the end of its gate/up phase, its pass of the grid barrier and its end) and,
for a non-zero entry, the gate/up phase forced to that many K slices (0: the
kernel's own plan). The copies build in parallel; then each runs in a
process of its own, one after another and back again, and at the 7B and 13B
MLP shapes (rows 1, 8, 64; bf16; packed weights rotated through copies past
the 50 MB L2) checks the kernel against ``q4_mlp_plain``, times it from a
CUDA-graph replay (``chip_smoke.time_ms``) and reads the stamps of one more
launch on cold weights: min / mean / max over the blocks of the gate/up
phase's end, of the barrier's pass and of the end, in microseconds from the
first block's start. It prints the card's name and power limit, a line per
variant and shape, and one JSON object as the last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "dynamic_llava_tpu_torch" / "csrc"
OUT = ROOT / "dynamic_llava_tpu_torch" / "_build"
ROWS = (1, 8, 64)

# (anchor, text that replaces it) in quant_mlp.cu: the stamps
STAMPS = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_stamps[4 * 1024];\n"
     "__device__ __forceinline__ unsigned long long stamp() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n"
     "}\n"),
    ("  run_phase<MT, 2>(smem, a);  // gate and up -> h\n"
     "  run_phase<MT, 1>(smem, a);  // (grid barrier) down -> y\n",
     "  if (threadIdx.x == 0) g_stamps[4 * blockIdx.x] = stamp();\n"
     "  run_phase<MT, 2>(smem, a);\n"
     "  if (threadIdx.x == 0) g_stamps[4 * blockIdx.x + 1] = stamp();\n"
     "  run_phase<MT, 1>(smem, a);\n"
     "  if (threadIdx.x == 0) g_stamps[4 * blockIdx.x + 3] = stamp();\n"),
    ("    cg::this_grid().sync();\n",
     "    cg::this_grid().sync();\n"
     "    if (threadIdx.x == 0) g_stamps[4 * blockIdx.x + 2] = stamp();\n"),
    ("extern \"C\" long long q4_mlp_scratch_bytes(",
     "extern \"C\" int q4_mlp_stamps(void* dst) {\n"
     "  return cudaMemcpyFromSymbol(dst, dllava::g_stamps, sizeof(dllava::g_stamps));\n"
     "}\n"
     "extern \"C\" long long q4_mlp_scratch_bytes("),
]
PLAN_LINE = ("  p->pa = tc_plan((F + kItemCols - 1) / kItemCols, K, kUnitBytes / (2 * kTB), "
             "kSlicedCost);\n")


def variant_dir(slices: int) -> Path:
    return OUT / f"profile_mlp_slices{slices}"


def prepare(slices: int) -> None:
    """The stamped copy of the sources (gate/up forced to ``slices`` K slices
    unless 0)."""
    d = variant_dir(slices)
    shutil.rmtree(d, ignore_errors=True)
    (d / "csrc").mkdir(parents=True)
    for f in CSRC.iterdir():
        shutil.copy(f, d / "csrc" / f.name)
    edits = list(STAMPS)
    if slices:
        edits.append((PLAN_LINE, PLAN_LINE + (
            f"  {{ const int nkc = (K + 127) / 128, ch = (nkc + {slices} - 1) / {slices};\n"
            "    p->pa.chunks = ch;\n    p->pa.slices = (nkc + ch - 1) / ch; }\n")))
    src = d / "csrc" / "quant_mlp.cu"
    text = src.read_text()
    for anchor, new in edits:
        if anchor not in text:
            raise SystemExit(f"profile_mlp.py: quant_mlp.cu has no {anchor[:50]!r}")
        text = text.replace(anchor, new, 1)
    src.write_text(text)


def run(slices: int, build_only: bool) -> dict:
    """In a process of its own: build the copy, or time and stamp it."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch import kernels
    from dynamic_llava_tpu_torch.ops import quant_matmul as qm

    d = variant_dir(slices)
    kernels.CSRC_DIR, kernels.BUILD_DIR = d / "csrc", d / "_build"
    lib = kernels.load_library().lib
    if build_only:
        return {}
    lib.q4_mlp_stamps.argtypes = [ctypes.c_void_p]
    if slices:  # the copy's scratch, not the mirror's: the plans differ
        plan = qm.mlp_plan
        qm.mlp_plan = lambda rows, k, f, dd, sms: plan(rows, k, f, dd, sms)._replace(
            scratch_bytes=lib.q4_mlp_scratch_bytes(rows, k, f, dd))
    stamps = (ctypes.c_ulonglong * 4096)()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for case in kc.MLP_CASES:
        copies = max(2, -(-(256 << 20) // (3 * case.k * case.f // 2)))
        weights, scales = kc.make_mlp_weights(case, dev, gen, copies)
        for rows in ROWS:
            kc.check_mlp_case(case, rows, False, dev, gen, weights[0], scales)
            x = torch.randn(rows, case.k, generator=gen, device=dev).bfloat16()
            ms = chip_smoke.time_ms([lambda ws=ws: qm.q4_mlp(x, *ws, *scales)
                                     for ws in weights], 30)
            torch.cuda.synchronize()
            qm.q4_mlp(x, *weights[-1], *scales)
            torch.cuda.synchronize()
            lib.q4_mlp_stamps(ctypes.cast(stamps, ctypes.c_void_p))
            t = [[stamps[4 * b + i] for i in range(4)] for b in range(sms)]
            t0 = min(r[0] for r in t)

            def spread(i):
                us = [(r[i] - t0) / 1e3 for r in t]
                return [min(us), sum(us) / len(us), max(us)]

            r = dict(ms=ms, gate_up_end_us=spread(1), barrier_us=spread(2), end_us=spread(3))
            out[f"{case.label} rows {rows}"] = r
            print(f"gate/up slices {slices or 'planned'}, {case.label} rows {rows}: kernel "
                  f"{ms:.4f} ms; us from the first block's start, min / mean / max over the "
                  "blocks: gate/up phase ends " + "/".join(f"{v:.1f}" for v in r["gate_up_end_us"])
                  + ", barrier passed " + "/".join(f"{v:.1f}" for v in r["barrier_us"])
                  + ", end " + "/".join(f"{v:.1f}" for v in r["end_us"]), flush=True)
        del weights
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--slices", default="0",
                        help="comma-separated gate/up K slices to force, 0 for the plan's own")
    parser.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        res = run(int(args.child[0]), args.child[1] == "build")
        if res:
            print("RESULT " + json.dumps(res))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_mlp.py: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    variants = [int(v) for v in args.slices.split(",")]
    for v in variants:
        prepare(v)
    me = [sys.executable, str(Path(__file__).resolve()), "--child"]
    builds = [subprocess.Popen(me + [str(v), "build"]) for v in variants]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("profile_mlp.py: a build failed")
    results = {}
    for v in variants + variants[::-1]:  # there and back: the card's pace drifts
        proc = subprocess.run(me + [str(v), "time"], capture_output=True, text=True)
        sys.stdout.write("".join(l + "\n" for l in proc.stdout.splitlines()
                                 if not l.startswith("RESULT ")))
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"profile_mlp.py: variant {v} failed")
        res = json.loads(next(l for l in proc.stdout.splitlines()
                              if l.startswith("RESULT "))[len("RESULT "):])
        results.setdefault(str(v), []).append(res)
    print(json.dumps({"device": smi, "gate_up_slices": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
