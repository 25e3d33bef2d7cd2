#!/usr/bin/env python3
"""Where K2-M's tensor-core kernel (``extend_mma_kernel``) spends its time,
phase by phase, at the chat and speculative-verify shapes.

    python3 tools/profile_extend.py

Run from the root of a checkout on one CUDA card. It copies
``dynamic_llava_tpu_torch/csrc`` into ``dynamic_llava_tpu_torch/_build/
profile_extend/`` (git-ignored) with ``%globaltimer`` stamps written into
``extend_attention.cu`` (each block's start, its q fragments in registers,
the end of its tile loop, the end of its own state's write, and in the block
that merges the splits its ticket, the splits' (m, l) in shared memory and
the end of the merge) and the block's tile count,
builds that copy, and at ``kernel_cases.EXTEND_CASES[:4] + VERIFY_CASES``
checks the kernel against its plain version, times it from a CUDA-graph
replay (``chip_smoke.time_ms``, as phase 3 does; the stamps add a few stores
a block) and reads the
stamps of one more launch: min / mean / max over the blocks of each phase's
end, in microseconds from the first block's start, and the same for the
block that ends last. With ``--targets 128,192,264`` it then times the
same cases at each of those split targets (``ops.decode_attention.
MMA_SPLIT_TARGET_BLOCKS``, which sets the plan's split), twice in turns. It
prints the card's name and power limit, a line per case (and per target),
and one JSON object as the last line.
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
COPY = ROOT / "dynamic_llava_tpu_torch" / "_build" / "profile_extend"
SLOTS = 12  # stamps a block: start, q, loop, own state, merge, tiles, ticket, (m, l), ...
MAX_BLOCKS = 8192
PHASES = ("q_us", "loop_us", "state_us", "ticket_us", "ml_us", "landed_us", "summed_us",
          "merge_us")
SLOT_OF = {"q_us": 1, "loop_us": 2, "state_us": 3, "merge_us": 4, "ticket_us": 6, "ml_us": 7,
           "landed_us": 8, "summed_us": 9}

# (anchor, text that replaces it) in extend_attention.cu
STAMPS = [
    ("#include \"common.cuh\"\n\nnamespace dllava {\n",
     "#include \"common.cuh\"\n\nnamespace dllava {\n"
     f"__device__ unsigned long long g_stamps[{SLOTS * MAX_BLOCKS}];\n"
     "__device__ __forceinline__ void put(int i, unsigned long long v) {\n"
     "  const unsigned blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
     f"  if (threadIdx.x == 0 && blk < {MAX_BLOCKS}) g_stamps[{SLOTS} * blk + i] = v;\n"
     "}\n"
     "__device__ __forceinline__ void stamp(int i) {\n"
     "  unsigned long long v;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v));\n"
     "  put(i, v);\n"
     "}\n"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  stamp(0);\n  for (int i = 4; i < 10; ++i) put(i, 0);\n"
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"),
    ("  float o[D / 8][4];\n", "  stamp(1);\n  put(5, nt);\n  float o[D / 8][4];\n"),
    ("  __syncthreads();  // the ring is free: the states may reuse it\n",
     "  __syncthreads();  // the ring is free: the states may reuse it\n  stamp(2);\n"),
    ("  if (a.n_split == 1) return;\n", "  stamp(3);\n  if (a.n_split == 1) return;\n"),
    ("  const float* part = a.ws + pair * a.n_split * region;\n",
     "  stamp(6);\n  const float* part = a.ws + pair * a.n_split * region;\n"),
    ("#pragma unroll 1\n  for (int qi = tid; qi < nq; qi += kThreads) {\n",
     "  stamp(7);\n#pragma unroll 1\n  for (int qi = tid; qi < nq; qi += kThreads) {\n"),
    ("    __syncthreads();  // the batch has landed\n",
     "    __syncthreads();  // the batch has landed\n    if (s0 == 0) stamp(8);\n"),
    ("    __syncthreads();  // the batch is consumed\n",
     "    __syncthreads();  // the batch is consumed\n    if (s0 == 0) stamp(9);\n"),
    ("  if (tid == 0) a.tickets[pair] = 0;  // for the next launch (a graph replay too)\n",
     "  if (tid == 0) a.tickets[pair] = 0;  // for the next launch (a graph replay too)\n"
     "  stamp(4);\n"),
    ("long long extend_mma_workspace_bytes(",
     "extern \"C\" int extend_mma_stamps(void* dst) {\n"
     "  return cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));\n"
     "}\n"
     "long long extend_mma_workspace_bytes("),
]


def prepare() -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    (COPY / "csrc").mkdir(parents=True)
    for f in CSRC.iterdir():
        shutil.copy(f, COPY / "csrc" / f.name)
    src = COPY / "csrc" / "extend_attention.cu"
    text = src.read_text()
    for anchor, new in STAMPS:
        if anchor not in text:
            raise SystemExit(f"profile_extend.py: extend_attention.cu has no {anchor[:50]!r}")
        text = text.replace(anchor, new, 1)
    src.write_text(text)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--targets", default="",
                        help="comma-separated split targets to time the cases at")
    opts = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_extend.py: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    import chip_smoke
    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch import kernels
    from dynamic_llava_tpu_torch.ops import decode_attention as tda
    from dynamic_llava_tpu_torch.ops.decode_attention import extend_attention

    prepare()
    kernels.CSRC_DIR, kernels.BUILD_DIR = COPY / "csrc", COPY / "_build"
    built = kernels.load_library()
    lib, entry = built.lib, ""
    for line in built.ptxas_log.splitlines():
        if "Compiling" in line:
            entry = line.split("'")[1]
        elif "extend_mma_kernel" in entry and ("Used" in line or "spill" in line):
            print(f"{entry[entry.index('extend_mma_kernel'):][:40]}: {line.strip()}", flush=True)
    lib.extend_mma_stamps.argtypes = [ctypes.c_void_p]
    stamps = (ctypes.c_ulonglong * (SLOTS * MAX_BLOCKS))()
    dev = torch.device("cuda")
    out = {}
    for case in kc.EXTEND_CASES[:4] + kc.VERIFY_CASES:
        kc.check_extend_case(case, dev)
        args, kw = kc.make_extend_inputs(case, dev, chip_smoke.SEED + 4)
        ms = chip_smoke.time_ms(lambda: extend_attention(*args, **kw), 50)
        plan = kc.extend_case_plan(case)
        blocks = case.hkv * plan.row_tiles * case.b * plan.n_split
        torch.cuda.synchronize()
        extend_attention(*args, **kw)
        torch.cuda.synchronize()
        lib.extend_mma_stamps(ctypes.cast(stamps, ctypes.c_void_p))
        rows = [[stamps[SLOTS * i + j] for j in range(SLOTS)] for i in range(blocks)]
        t0 = min(r[0] for r in rows)
        last = max(rows, key=lambda r: max(r[3], r[4]))

        def us(r, i):
            return (r[i] - t0) / 1e3 if r[i] else None

        res = dict(ms=ms, blocks=blocks, splits=plan.n_split,
                   tiles=[min(r[5] for r in rows), max(r[5] for r in rows)],
                   last_block={"tiles": last[5], **{p: us(last, SLOT_OF[p])
                                                     for p in PHASES}})
        for p in PHASES:
            vals = [us(r, SLOT_OF[p]) for r in rows if r[SLOT_OF[p]]]
            res[p] = [min(vals), sum(vals) / len(vals), max(vals)] if vals else None
        out[case.label] = res
        print(f"{case.label}: kernel {ms:.4f} ms, {blocks} blocks, {plan.n_split} splits, "
              f"tiles {res['tiles'][0]}-{res['tiles'][1]}; us from the first block's start, "
              "min / mean / max over the blocks: " + ", ".join(
                  f"{p[:-3]} " + ("/".join(f"{v:.1f}" for v in res[p]) if res[p] else "-")
                  for p in PHASES)
              + f"; the last block ({last[5]} tiles): " + ", ".join(
                  f"{p[:-3]} {res['last_block'][p]:.1f}" for p in PHASES
                  if res["last_block"][p] is not None), flush=True)
    sweep = {}
    targets = [int(v) for v in opts.targets.split(",") if v]
    cases = kc.EXTEND_CASES[:4] + kc.VERIFY_CASES
    inputs = [kc.make_extend_inputs(case, dev, chip_smoke.SEED + 4) for case in cases]
    planned = tda.MMA_SPLIT_TARGET_BLOCKS
    for target in targets + targets[::-1]:  # there and back: the card's pace drifts
        tda.MMA_SPLIT_TARGET_BLOCKS = target
        row = sweep.setdefault(str(target), {})
        for case, (a, kw) in zip(cases, inputs):
            ms = chip_smoke.time_ms(lambda: extend_attention(*a, **kw), 50)
            row.setdefault(case.label, []).append(ms)
        print(f"split target {target}: " + "; ".join(
            f"{c.label} {row[c.label][-1]:.4f} ms ({kc.extend_case_plan(c).n_split} splits)"
            for c in cases), flush=True)
    tda.MMA_SPLIT_TARGET_BLOCKS = planned
    print(json.dumps({"device": smi, "cases": out, "split_targets": sweep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
