#!/usr/bin/env python3
"""Compare this checkout's port with another checkout's (a parent commit) on
one card, in turns: other, this, this, other.

    python3 tools/compare_parent.py --other build/parent

``--other`` is the root of an unpacked checkout (``git archive <commit>``)
that has ``dynamic_llava_tpu_torch/``. Each turn is a subprocess that
imports the port from one root only (so each builds its own kernels) and
measures, on an NVIDIA GPU:

* K2 (``decode_attention``): mean device time of one call, CUDA events over
  a CUDA-graph replay of 100 calls, 32 heads, head_dim 128, every sample one
  row short of the capacity, at B = 4 / 8 and 768 / 256 slots, bf16 and
  int8 caches, and B = 1 at 1088 slots;
* K2-M (``extend_attention``): the same, 50 calls, at
  ``kernel_cases.EXTEND_CASES[:4] + VERIFY_CASES`` (the chat rounds' and the
  speculative verify rounds' shapes);
* decode at LLaVA-1.5-7B width (32 layers, random bf16 weights from a seed),
  B = 8 requests of one 336x336 image and 60 text tokens, 64 greedy new
  tokens, sparse and dense: the graph step wall (host clock around the
  runner's chunks after a prefill, the median of three) and decode tok/s
  (``B * 64 / (generate - prefill)``, medians of three of each);
* the speculative verify round on the same weights and requests (B = 8 and
  the first one alone), sparse and dense, k = 4 and 7: its device time,
  CUDA events over 10 replays of the captured round on a fresh prefill.

The last line of output is a JSON object with every turn's readings and
the card's name and power limit. It fails without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SEED = 0
K2_SHAPES = [(4, 768, "own"), (4, 768, "int8"), (8, 768, "own"), (8, 256, "own"),
             (8, 256, "int8"), (1, 1088, "own")]


def time_ms(torch, fn, iters: int = 100) -> float:
    """Mean device time of ``fn`` over ``iters`` calls replayed from one
    CUDA graph, after a warm-up replay."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(root: Path) -> dict:
    """One turn: the readings of the port under ``root``."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch import kernels
    from dynamic_llava_tpu_torch.config import (
        DENSE_SPARSE_CONFIG, IMAGE_TOKEN_INDEX, LlavaConfig)
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
    from dynamic_llava_tpu_torch.ops.decode_attention import decode_attention, extend_attention
    from dynamic_llava_tpu_torch.weights import init_llava_params

    assert Path(kernels.__file__).resolve().is_relative_to(root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": str(root), "k2_ms": {}, "k2m_ms": {}, "decode": {}, "verify_round_ms": {}}
    t0 = time.perf_counter()
    kernels.load_library()
    out["build_s"] = time.perf_counter() - t0
    for b, max_len, storage in K2_SHAPES:
        case = kc.DecodeCase("t", b, max_len, 32, 32, 128, torch.bfloat16, storage,
                             (max_len - 1,) * b)
        args, kw = kc.make_decode_inputs(case, "cuda", SEED + 3)
        out["k2_ms"][f"B={b} max_len={max_len} {storage}"] = time_ms(
            torch, lambda: decode_attention(*args, **kw))
    for case in kc.EXTEND_CASES[:4] + kc.VERIFY_CASES:
        args, kw = kc.make_extend_inputs(case, "cuda", SEED + 4)
        out["k2m_ms"][case.label] = time_ms(torch, lambda: extend_attention(*args, **kw), 50)

    dev = torch.device("cuda")
    cfg = LlavaConfig()
    params = init_llava_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                               torch.bfloat16)
    rng = np.random.default_rng(SEED)
    b, n_text, max_new = 8, 60, 64
    ids = [np.concatenate([rng.integers(3, cfg.text.vocab_size, n_text // 2),
                           [IMAGE_TOKEN_INDEX],
                           rng.integers(3, cfg.text.vocab_size, n_text - n_text // 2)])
           for _ in range(b)]
    size = cfg.vision.image_size
    pix = rng.standard_normal((b, size, size, 3), dtype=np.float32)
    for mode, mcfg in (("sparse", cfg), ("dense", LlavaConfig(sparse=DENSE_SPARSE_CONFIG))):
        gc = GenerationConfig(max_new_tokens=max_new, temperature=0.0, eos_token_id=-1)
        gen = Generator(params, mcfg, gc)
        plan = plan_batch(ids, mcfg.num_image_tokens, pad_multiple=gc.pad_multiple)
        for _ in range(2):  # the first captures the step
            gen.generate(ids, pix)
        e2es, ttfts, steps = [], [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen.generate(ids, pix)
            torch.cuda.synchronize()
            e2es.append(time.perf_counter() - t0)
            with torch.inference_mode():
                t0 = time.perf_counter()
                state, _ = gen.prefill_from_plan(plan, pix, max_new)
                torch.cuda.synchronize()
                ttfts.append(time.perf_counter() - t0)
                runner = gen.runner(plan, pix, max_new)
                runner.load(state, 0)
                del state
                n = max_new // runner.chunk
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pending = runner.run_chunk()
                for ci in range(n):
                    following = runner.run_chunk() if ci + 1 < n else None
                    pending.tokens()
                    pending = following
                steps.append((time.perf_counter() - t0) * 1e3 / max_new)
        e2e, ttft = statistics.median(e2es), statistics.median(ttfts)
        out["decode"][mode] = dict(graph_step_ms=statistics.median(steps),
                                   decode_tok_s=b * max_new / (e2e - ttft),
                                   ttft_ms=ttft * 1e3)
        for nb in (1, b):
            sub = plan_batch(ids[:nb], mcfg.num_image_tokens, pad_multiple=gc.pad_multiple)
            for k in (4, 7):
                gen.generate_speculative_device(ids[:nb], pix[:nb], draft_k=k)  # captures
                with torch.inference_mode():
                    runner = gen.decode_runner
                    state, _ = gen.prefill_into(sub, pix[:nb], runner.fresh_cache())
                    runner.load(state, 0)
                    runner.begin(sub, max_new)
                    del state
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(10):
                        runner.graph.replay()
                    end.record()
                    torch.cuda.synchronize()
                out["verify_round_ms"][f"{mode} B={nb} k={k}"] = start.elapsed_time(end) / 10
        del gen, runner
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="root of the other checkout")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)  # one turn
    args = ap.parse_args()
    if args.measure is not None:
        print("TURN " + json.dumps(measure(args.measure)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_parent.py: torch.cuda.is_available() is False")
    if args.other is None or not (args.other / "dynamic_llava_tpu_torch").is_dir():
        raise SystemExit("compare_parent.py: --other must be a checkout's root")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    turns = []
    for root in (args.other, ROOT, ROOT, args.other):
        env = dict(os.environ, PYTHONPATH="")
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure",
                              str(root.resolve())], capture_output=True, text=True, env=env,
                             cwd=str(root))
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("TURN ")]
        if res.returncode != 0 or not line:
            print(res.stdout[-4000:], res.stderr[-4000:], flush=True)
            raise SystemExit(f"compare_parent.py: the turn on {root} failed")
        turn = json.loads(line[0][5:])
        turn["which"] = "this" if root == ROOT else "other"
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
