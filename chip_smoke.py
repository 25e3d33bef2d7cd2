#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card with 80 GB, ``nvcc``
and about five minutes, and fails (exit code != 0, no result line)
anywhere else. Phases, each of which raises on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``dynamic_llava_tpu_torch/csrc``
   with ``nvcc`` for ``sm_90a`` (one process per source, in parallel) and
   print the build time and ``ptxas`` resource lines;
3. hold each kernel against its plain PyTorch version at the shapes of the
   main paths, timing both with CUDA events on a CUDA-graph replay, and
   beside them the one PyTorch call that computes the same function where
   there is one (a yardstick timed here and used nowhere in the port).
   K1/K2: bf16 inputs against the plain version in fp32 on the same
   values, atol = rtol = 2e-2 (bf16 output rounding, and in K1 and K3 the
   probabilities and dS rounded to bf16 for the tensor cores); fp32 inputs
   at atol = rtol = 1e-4. K3 (dq, dk, dv each, and its delta kernel) and K4
   at the training shape (B=4, S=1663, H=32, d=128) the same way; K4's bf16
   error there must also be at most twice that of the output's own bf16
   rounding, and it is timed beside SDPA with a causal + log(policy) float
   mask (not the same function: no eps terms) and with its column-sum
   kernel apart; K4 also at every ``kernel_cases.POLICY_EDGE_CASES`` case
   (S = 1, 63, 64, 65, 129; 4 query heads a KV head; d 64 and 128; a policy
   of zeros, ones or soft values; bf16 and fp32), each launched twice with
   ``torch.equal`` results. K1 and
   K3 at every ``kernel_cases.FLASH_FWD_CASES`` / ``FLASH_BWD_CASES`` case,
   the edges of their 64-row tiles among them (S = 64, 65, 130, 200; GQA
   with 4 query heads a KV head; a ``kv_length`` of 0 and one in mid-tile;
   K1 with a ``q_offset`` and Sq < Sk; bf16 and fp32), each launched twice
   with ``torch.equal`` results; K1 is timed beside SDPA both with the masks
   as a bool tensor and, at full lengths, with ``is_causal``; K3's delta
   kernel beside ``torch.linalg.vecdot`` on the fp32 values it forms;
   ``torch.autograd.grad`` through K1 + K3 against autograd through the
   plain forward, and the gradient of an unfrozen CLIP tower on the card
   against the CPU's. K2 at every ``kernel_cases.DECODE_CASES`` case: bf16,
   fp32, scaled-int8 and fp8 storage; lengths 0, 1, below / at / above the
   kernel's tile and split edges, at the capacity and past it; a sliding
   window, also one that opens inside a split; head_dim 64 and 128; 1-8
   query heads a KV head; B = 8; each launched twice with ``torch.equal``
   results; timed at max_len 768 / 256 and B = 4 / 8 beside one SDPA call
   (for int8 / fp8 storage: on the dequantized bf16 cache). K5-K8 (int8 /
   int4 GEMVs) at the 7B decoder's shapes (q/k/v, gate/up, down with
   K = 11008, o, the lm_head with N = 32000) and rows 1, 8, 24, 64, and at
   the ``kernel_cases.QUANT_EDGE_CASES`` (a three-weight group of unequal
   widths, widths and K that end inside a tile or a k16 step, the 13B
   shapes), each launched twice with ``torch.equal`` results: max abs error
   relative to max |ref| within 1e-2 for bf16 outputs, 1e-4 for the fp32
   lm_head; the weights rotate through copies larger than the 50 MB L2, as
   a decode step finds them cold, and the yardstick (``@`` on the
   dequantized bf16 weight) is timed on one copy and, at rows 8, rotated
   the same way. K9 (the fused int4 MLP) at the 7B and 13B MLP shapes and
   the same rows and at ``kernel_cases.MLP_EDGE_CASES`` (F and D that end
   inside a tile, K inside a unit, unsliced phases) at rows 1, 7, 17, 64,
   bf16 x and fp32 x with fp32 out (1e-2 / 1e-3 of max |ref|), each
   launched twice with ``torch.equal`` results, beside the two-kernel path
   it fuses and three bf16 matmuls on the dequantized weights. A
   tensor-core attention kernel, the decode-attention kernel, the bf16
   GEMV kernel or the fused MLP that spills registers fails the run
   (phase 2);
4. a small model (head_dim 64, GQA) on the card through the kernels
   against the port's plain CPU path, which the CPU tests hold against the
   JAX package: greedy generation in fp32 with plain, int8 and int4
   weights, token for token; the lean modes (int8 and fp8 KV, ring
   overflow, int4 with the fused MLP) by their logits under teacher
   forcing; and two train steps in fp32 on shared Gumbel
   noise, losses within rtol 1e-3 and every parameter within atol 1e-4;
5. serving at LLaVA-1.5-7B width (32 layers, random bf16 weights made on
   the card from a seed): two batches of 8 requests (one 336x336 image
   and 60 text tokens each, 64 new tokens, greedy) through
   ``Generator.generate``, sparse and then dense: the main path. Decode
   replays a CUDA graph of the step (captured in the first call), whose
   replays launch their kernels without a wrapper call; so in each
   serving mode of phases 5-8 the wrappers' counters (host calls: eager
   launches and the capture's) are zeroed just before the two calls and
   read just after, and the serving kernels' launches on the card are
   counted by name in a ``torch.profiler`` trace of the same two calls
   (``kernel_cases.device_launches``). Those must equal twice the wrapper
   calls of an eager loop of ``argmax`` + ``decode_step`` written here
   (``eager_decode``) over the same prefill and steps, and the graph's
   tokens the eager loop's;
6. quantized serving at 7B width, the same batches: the phase-5 weights
   quantized in place to int8 (``quantize_llm_params``), sparse and dense;
   then an int4 decoder made directly (``init_quantized_llama_params``)
   beside the bf16 tower, projector and predictors, sparse;
7. lean-memory serving at 7B width on the int4 decoder, the same batches,
   within one process so that the modes can be compared: bf16 KV with the
   fused MLP (K9, ``DYNAMIC_LLAVA_Q4_MLP=1``) off, on, on, off; fused with
   an int8 KV cache, sparse and dense; fused with an fp8 cache, sparse;
   then ring overflow (int8 KV, 256 new tokens at a decode window of 64,
   so both tiers wrap). On the card K9 must launch once per layer and
   decode step with the switch on and never with it off, K2 once per layer
   and step in every mode. Cache bytes and peak memory are printed;
8. LLaVA-1.5-13B width (40 layers, hidden 5120, ffn 13824), an int4
   decoder made directly, fused MLP, B=1, 256 new tokens, sparse and dense;
9. training at 7B width (TRAIN_DEPTH decoder layers, fresh random bf16
   weights): ``Trainer.train`` over TRAIN_STEPS sparse steps (B=4, one
   336x336 image + 1088 text tokens each, half of them labels, fused
   S = 1663), then as many dense-stage steps on the same weights; the
   launch counters of K1, K3 (all three kernels) and K4 are zeroed before each
   and must equal the counts the layer layout implies; the loss must be
   finite and the parameters changed.

After the main path of each serving mode, outside its counts and trace,
TIMED more batches are timed (the graph is reused), each followed by its
prefill timed again alone; with the medians of both, TTFT is the prefill's
and decode tok/s is ``B * 64 / (batch time - TTFT)``. The
decode step walls of the graph and of the eager loop are both host clock
around the decode steps alone after a prefill (``graph_decode``,
``eager_decode``). A train step is timed on the host clock after
``synchronize``, the first apart. The last two lines of standard output
are a JSON object with each kernel's error, times, bound (the larger of
its bytes over 3.35 TB/s and its operations over the card's peak for its
input type, from this run's inputs), launches (on the card, from the
trace: a GEMV wrapper and its group form launch one kernel, whose count
both report) and wrapper calls, and ``{"ok": true, "device": {...}}``.
Before them a ``decode_graph`` line gives, per serving mode, the decode
step wall of the eager loop and of the graph, the capture's ms and
whether the tokens were equal.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
BF16_TOL = 2e-2
FP32_TOL = 1e-4
TRAIN_DEPTH = 32  # decoder layers of the training phase (width is never cut)
TRAIN_STEPS = 3  # per mode; the first is timed apart
TRAIN_BATCH, TRAIN_TEXT_LEN = 4, 1088  # fused S = 1088 - 1 + 576 = 1663
TIMED = 3  # timed generate calls and prefills a serving mode
# published peaks of one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, replayed from one CUDA
    graph (so the Python launch cost of a small kernel does not pace the
    card), timed with CUDA events after a warm-up replay. A list of
    functions is called in turn."""
    import torch

    fns = fn if isinstance(fn, list) else [fn]
    for f in fns[:2]:  # builds, sets kernel attributes, warms the allocator
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def time_events_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` eager calls after two
    warm-up calls (for calls that do not capture into a CUDA graph)."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms_by_name(fn, iters: int = 5) -> dict:
    """Mean device time a call of ``fn`` spends in each kernel, by kernel
    name, from ``torch.profiler`` over ``iters`` eager calls after a
    warm-up call (for a wrapper that launches more than one kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    require(out, "the profiler saw no device time")
    return out


def bound_ms(nbytes: float, flops: float, kind: str = "bf16"):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak for the input type.
    Returns (ms, "bytes" | "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attended_pairs(b: int, sq: int, sk: int, causal: bool, lens=None) -> int:
    """(query row, kv column) pairs the masks leave, summed over the batch."""
    total = 0
    for i in range(b):
        n = sk if lens is None else max(0, min(int(lens[i]), sk))
        if causal:
            full = max(0, sq - n)  # rows that see all n columns
            tri = min(sq, n)
            total += tri * (tri + 1) // 2 + full * n
        else:
            total += sq * n
    return total


def sdpa_layout(t):
    """[B, S, H, d] -> contiguous [B, H, S, d], the library call's layout."""
    return t.transpose(1, 2).contiguous()


def check_kernels(torch):
    """Phase 3, K1: the flash forward against its plain version at every
    ``kernel_cases.FLASH_FWD_CASES`` case (main-path shapes and the edges of
    its tiles, bf16 and fp32), each launched twice for equal bits; timed at
    the decoder's pre-tier and the CLIP tower's shapes. Returns its results
    (max error over all cases, times at the decoder shape)."""
    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    import torch.nn.functional as F

    dev = torch.device("cuda")
    res = {"flash_attention_fwd": {"max_abs_err": 0.0}}
    for case in kc.FLASH_FWD_CASES:
        try:
            err, lse_err = kc.check_flash_fwd_case(case, dev)
        except AssertionError as e:
            raise RuntimeError(str(e)) from e
        tol = kc.FP32_TOL if case.dtype == torch.float32 else kc.BF16_TOL
        log(f"  K1 {case.label} {kc.describe_flash_case(case)}: max_abs_err={err:.3e}, lse "
            f"{lse_err:.3e} (atol=rtol={tol:g}), two launches equal: ok")
        res["flash_attention_fwd"]["max_abs_err"] = max(
            res["flash_attention_fwd"]["max_abs_err"], err)
        if case.label not in ("decoder pre tier", "clip tower"):
            continue
        q, k, v, _, kvl = kc.make_flash_inputs(case, dev)
        b, s, h, d = q.shape
        causal, lens = case.causal, case.lengths
        kms = time_ms(lambda: flash_attention(q, k, v, kv_length=kvl, causal=causal))
        pms = time_ms(lambda: flash_attention_plain(q, k, v, kv_length=kvl, causal=causal))
        # yardstick: one SDPA call on the same inputs, the masks as a bool mask
        ql, kl, vl = sdpa_layout(q), sdpa_layout(k), sdpa_layout(v)
        cols = torch.arange(s, device=dev)
        mask = torch.ones((b, 1, s, s), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (cols[None, :] <= cols[:, None])
        if kvl is not None:
            mask = mask & (cols[None, :] < kvl[:, None])[:, None, None, :]
        lms = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask))
        # the bool mask keeps SDPA off its flash backend: also at full
        # lengths without a mask tensor, the kernel on the same inputs
        full_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal))
        lfull_ms = time_ms(
            lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal))
        pairs = attended_pairs(b, s, s, causal, lens)
        bms, bby = bound_ms(2 * (2 * q.numel() + 2 * k.numel()), 4 * pairs * d * h)
        log(f"  K1 {case.label} time: kernel {kms:.4f} ms, plain {pms:.4f} ms, SDPA "
            f"(bool mask) {lms:.4f} ms, bound {bms:.4f} ms ({bby}); every sample at "
            f"full length: kernel {full_ms:.4f} ms, SDPA is_causal={causal} "
            f"{lfull_ms:.4f} ms")
        timing = dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=bby,
                      full_length_ms=full_ms, library_full_length_ms=lfull_ms)
        if case.label == "decoder pre tier":
            res["flash_attention_fwd"].update(timing)
        else:
            res["flash_attention_fwd"]["clip"] = timing

    torch.cuda.synchronize()
    return res


def check_decode_kernel(torch):
    """Phase 3, K2: every ``kernel_cases.DECODE_CASES`` case (bf16, fp32,
    scaled-int8 and fp8 storage; lengths 0, 1, at the edges of the kernel's
    tiles and splits, at the capacity and past it; a window, also inside a
    split; head_dim 64 and 128; 1-8 query heads a kv head; B = 8) against
    the plain version in fp32 on the same stored values, each launched twice
    for equal bits. Times (CUDA events over a graph replay) at max_len 768
    and 256 with every sample one row short of the capacity, B = 4 (the
    table's shapes) and B = 8, beside one SDPA call over the live rows (for
    int8 / fp8 storage: on the dequantized bf16 cache). Returns the kernel's
    results: max errors, the bf16 times at B = 4, max_len 768, and the other
    readings under ``int8`` / ``fp8`` / ``shapes``."""
    import torch.nn.functional as F

    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain)
    from dynamic_llava_tpu_torch.ops.kv_cache import dequantize_kv

    dev = torch.device("cuda")
    res = {"max_abs_err": 0.0, "int8": {"max_abs_err": 0.0}, "fp8": {"max_abs_err": 0.0},
           "shapes": {}}
    before = decode_attention.launches
    for case in kc.DECODE_CASES:
        try:
            err = kc.check_decode_case(case, dev)
        except AssertionError as e:
            raise RuntimeError(str(e)) from e
        tol = kc.FP32_TOL if case.dtype == torch.float32 else kc.BF16_TOL
        log(f"  {kc.describe_decode_case(case)}: max_abs_err={err:.3e} (atol=rtol={tol:g}), "
            "two launches equal: ok")
        top = res[case.storage] if case.storage in res else res
        top["max_abs_err"] = max(top["max_abs_err"], err)
    require(decode_attention.launches == before + 2 * len(kc.DECODE_CASES),
            "K2 launch counter")

    for b, max_len, storage in [(4, 768, "own"), (4, 768, "int8"), (4, 768, "fp8"),
                                (4, 256, "own"), (8, 768, "own"), (8, 768, "int8"),
                                (8, 256, "own"), (8, 256, "int8")]:
        n_live, h, d, dtype = max_len - 1, 32, 128, torch.bfloat16
        case = kc.DecodeCase("timing", b, max_len, h, h, d, dtype, storage, (n_live,) * b)
        (q, kc_, vc, kn, vn, live), kw = kc.make_decode_inputs(case, dev, SEED + 3)
        kms = time_ms(lambda: decode_attention(q, kc_, vc, kn, vn, live, **kw), 100)
        pms = time_ms(lambda: decode_attention_plain(q, kc_, vc, kn, vn, live, **kw), 100)
        ks, vs = kw["k_scale"], kw["v_scale"]
        kd = dequantize_kv(kc_, ks, dtype) if ks is not None else kc_.to(dtype)
        vd = dequantize_kv(vc, vs, dtype) if vs is not None else vc.to(dtype)
        ql = sdpa_layout(q)
        kl = sdpa_layout(torch.cat([kd[:, :n_live], kn], dim=1))
        vl = sdpa_layout(torch.cat([vd[:, :n_live], vn], dim=1))
        lms = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl), 100)
        # bytes: the live cache rows in their storage type (int8: and their
        # bf16 scales), q, the current K/V and the output in q's type
        per_elem = 2 if storage == "own" else 1
        cache = 2 * b * n_live * h * (d * per_elem + (2 if storage == "int8" else 0))
        bms, bby = bound_ms(cache + 2 * (2 * q.numel() + 2 * b * h * d),
                            4 * b * (n_live + 1) * h * d)
        log(f"  K2 time, B={b} max_len={max_len}, {storage} cache, every sample at length "
            f"{n_live}: kernel {kms:.4f} ms, plain {pms:.4f} ms, SDPA"
            f"{'' if storage == 'own' else ' on the dequantized bf16 cache'} {lms:.4f} ms, "
            f"bound {bms:.4f} ms ({bby})")
        timing = dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=bby)
        if (b, max_len) == (4, 768):
            (res if storage == "own" else res[storage]).update(timing)
        else:
            res["shapes"][f"B={b} max_len={max_len} {storage}"] = timing
    torch.cuda.synchronize()
    return res


def check_quant_kernels(torch):
    """Phase 3, K5-K8: each GEMV against its plain version on the same
    bf16 x and int8 / packed int4 weights (bf16 scales), at every
    ``kernel_cases.QUANT_CASES`` shape and ``QUANT_ROWS`` row count and at
    the ``QUANT_EDGE_CASES`` (a three-weight group of unequal widths, widths
    and K that end inside a tile, a k16 step or a unit, the 13B shapes),
    each launched twice for equal bits. Times (CUDA events over a graph
    replay) rotate through weight copies of more than 256 MB, so that every
    call reads its weights from HBM as a decode step does; beside them the
    plain version and ``@`` on the dequantized bf16 weight, on one copy (as
    every earlier run timed it: up to 50 MB of it stay in the L2) and, at
    rows 8, rotated like the kernel's. Returns per-kernel results: max
    errors over all cases, times at rows 8 of the largest shape, and every
    shape's readings under ``shapes``."""
    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = {name: {"max_abs_err": 0.0, "max_err_rel": 0.0, "shapes": {}}
           for name in ("q8_gemv", "q8_gemv_group", "q4_gemv", "q4_gemv_group")}

    def check(case, bits, rows, weights, scales):
        name = kc.gemv_functions(bits, len(case.ns) > 1)[0]
        try:
            err, rel = kc.check_gemv_case(case, bits, rows, dev, gen, weights, scales)
        except AssertionError as e:
            raise RuntimeError(str(e)) from e
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        res[name]["max_err_rel"] = max(res[name]["max_err_rel"], rel)
        return (f"  {name} int{bits} {case.label} [K={case.k} N={'+'.join(map(str, case.ns))} "
                f"rows={rows}{' fp32 out' if case.out_fp32 else ''}]: max_abs_err={err:.3e}, "
                f"/max|ref| {rel:.3e} (tol {kc.QUANT_TOL[case.out_fp32]:g}), two launches "
                "equal: ok")

    for bits in (8, 4):
        for case in kc.QUANT_EDGE_CASES:
            (weights,), scales = kc.make_gemv_weights(case, bits, dev, gen)
            for rows in kc.QUANT_EDGE_ROWS:
                log(check(case, bits, rows, weights, scales))
        for case in kc.QUANT_CASES:
            name, kernel, plain = kc.gemv_functions(bits, len(case.ns) > 1)
            nbytes = case.k * sum(n // 2 if bits == 4 else n for n in case.ns)
            copies = max(2, -(-(256 << 20) // nbytes))
            weights, scales = kc.make_gemv_weights(case, bits, dev, gen, copies)
            for rows in kc.QUANT_ROWS:
                line = check(case, bits, rows, weights[0], scales)
                x = torch.randn(rows, case.k, generator=gen, device=dev).bfloat16()
                kms = time_ms([lambda ws=ws: kc.call_gemv(kernel, case, x, ws, scales)
                               for ws in weights], 30)
                pms = time_ms([lambda ws=ws: kc.call_gemv(plain, case, x, ws, scales)
                               for ws in weights[:2]], 10)

                def dequantized(ws):
                    return [(qm.unpack_int4(w) if bits == 4 else w).bfloat16() for w in ws]

                deq = dequantized(weights[0])
                mms = time_ms(lambda: [x @ w for w in deq], 10)
                line += (f"; kernel {kms:.4f} ms ({nbytes / kms / 1e6:.0f} GB/s of weights), "
                         f"plain {pms:.4f} ms, bf16 matmul on the dequantized weight (one "
                         f"copy) {mms:.4f} ms")
                shape = dict(ms=kms, plain_ms=pms, library_ms=mms)
                if rows == 8:  # the yardstick on cold weights too
                    deqs = [deq] + [dequantized(ws) for ws in weights[1:]]
                    cold = time_ms([lambda d=d: [x @ w for w in d] for d in deqs], 30)
                    del deqs
                    io = 2 * sum(sc.numel() for sc in scales) + 2 * x.numel() + \
                        (4 if case.out_fp32 else 2) * rows * sum(case.ns)
                    bms, bby = bound_ms(nbytes + io, 2 * rows * case.k * sum(case.ns))
                    line += (f", rotated through {copies} copies {cold:.4f} ms; bound "
                             f"{bms:.4f} ms ({bby})")
                    shape.update(library_cold_ms=cold, bound_ms=bms, bound_by=bby)
                    # the JSON line's required keys: the decode step's largest GEMVs
                    if case.label == ("gate/up" if len(case.ns) > 1 else "down"):
                        res[name].update(shape, shape=f"{case.label} rows 8")
                del deq
                log(line)
                res[name]["shapes"][f"{case.label} rows {rows}"] = shape
            del weights
    torch.cuda.synchronize()
    return res


def check_mlp_kernel(torch):
    """Phase 3, K9: the fused int4 MLP against ``q4_mlp_plain`` on the same
    x, packed weights and bf16 scales at every ``kernel_cases.MLP_CASES``
    shape and ``QUANT_ROWS`` row count and at the ``MLP_EDGE_CASES`` (F and D
    that end inside a tile, K inside a unit, unsliced phases) and
    ``MLP_EDGE_ROWS``, bf16 x (bf16 out) and fp32 x (fp32 out: the kernel
    rounds x to bf16 as the plain version does, so only the order of the fp32
    sums and the rare h that rounds the other way differ; at the main shapes
    both are also held against the same arithmetic in float64), each launched
    twice for equal bits. Times rotate through weight copies of more than 256
    MB. Beside the kernel: the two-kernel path it fuses (K8 gate/up + ``silu
    * mul`` + K7 down) and three ``@`` on dequantized bf16 weights + ``silu *
    mul``."""
    import torch.nn.functional as F

    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    res = {"max_abs_err": 0.0, "max_err_rel": 0.0, "shapes": {}}

    def check(case, rows, fp32, weights, scales):
        try:
            err, rel, x = kc.check_mlp_case(case, rows, fp32, dev, gen, weights, scales)
        except AssertionError as e:
            raise RuntimeError(str(e)) from e
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["max_err_rel"] = max(res["max_err_rel"], rel)
        return x, (f"  q4_mlp {case.label} [K={case.k} F={case.f} D={case.d} rows={rows} "
                   f"{x.dtype}]: max_abs_err={err:.3e}, /max|ref| {rel:.3e} (tol "
                   f"{kc.MLP_TOL[fp32]:g}), two launches equal: ok")

    for case in kc.MLP_EDGE_CASES:
        (weights,), scales = kc.make_mlp_weights(case, dev, gen)
        for rows in kc.MLP_EDGE_ROWS:
            for fp32 in (False, True):
                log(check(case, rows, fp32, weights, scales)[1])
    for case in kc.MLP_CASES:
        k, f = case.k, case.f
        nbytes = 3 * k * f // 2
        copies = max(2, -(-(256 << 20) // nbytes))
        weights, scales = kc.make_mlp_weights(case, dev, gen, copies)

        def two_kernels(x, ws):
            g, u = qm.q4_gemv_group(x, ws[:2], scales[:2])
            return qm.q4_gemv(F.silu(g) * u, ws[2], scales[2])

        def float64(x, ws):  # q4_mlp_plain's steps in float64
            xb, (sg, su, sd) = x.bfloat16().double(), (sc.double() for sc in scales)
            g = (xb @ qm.unpack_int4(ws[0]).double()) * sg
            u = (xb @ qm.unpack_int4(ws[1]).double()) * su
            h = (F.silu(g) * u).float().bfloat16().double()
            return (h @ qm.unpack_int4(ws[2]).double()) * sd

        for rows in kc.QUANT_ROWS:
            for fp32 in (False, True):
                x, line = check(case, rows, fp32, weights[0], scales)
                if fp32:
                    got = qm.q4_mlp(x, *weights[0], *scales, out_fp32=True)
                    want = qm.q4_mlp_plain(x, *weights[0], *scales, out_fp32=True)
                    r64 = float64(x, weights[0])
                    top = r64.abs().max().item()
                    line += (f"; against float64 /max|ref|: kernel "
                             f"{(got.double() - r64).abs().max().item() / top:.3e}, plain "
                             f"{(want.double() - r64).abs().max().item() / top:.3e}")
                    del r64, got, want
                    if rows != 8:
                        log(line)
                        continue
                kms = time_ms([lambda ws=ws: qm.q4_mlp(x, *ws, *scales, out_fp32=fp32)
                               for ws in weights], 30)
                log(line + f"; kernel {kms:.4f} ms ({nbytes / kms / 1e6:.0f} GB/s of weights)")
                if fp32:
                    continue
                two_ms = time_ms([lambda ws=ws: two_kernels(x, ws) for ws in weights], 30)
                log(f"    K8 gate/up + silu*mul + K7 down on the same inputs: {two_ms:.4f} ms "
                    f"(K9 {kms / two_ms:.2f}x)")
                shape = dict(ms=kms, two_kernel_ms=two_ms)
                if rows == 8:
                    pms = time_ms([lambda ws=ws: qm.q4_mlp_plain(x, *ws, *scales)
                                   for ws in weights[:2]], 5)
                    deq = [qm.unpack_int4(w).bfloat16() for w in weights[0]]
                    mms = time_ms(lambda: (F.silu(x @ deq[0]) * (x @ deq[1])) @ deq[2], 10)
                    del deq
                    io = 2 * sum(sc.numel() for sc in scales) + 2 * x.numel() + 2 * rows * k
                    bms, bby = bound_ms(nbytes + io, 6 * rows * k * f)
                    log(f"    rows 8: plain {pms:.4f} ms, three bf16 matmuls on the "
                        f"dequantized weights (one copy) + silu*mul {mms:.4f} ms, bound "
                        f"{bms:.4f} ms ({bby})")
                    shape.update(plain_ms=pms, library_ms=mms, bound_ms=bms, bound_by=bby)
                    res["shapes"][case.label] = dict(shape)
                res["shapes"][f"{case.label} rows {rows}"] = shape
        del weights
    res.update(res["shapes"]["7B"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res


def check_train_kernels(torch):
    """Phase 3, K3 and K4: the flash backward (dq, dk, dv each) and the
    policy attention against their plain versions at the training shape,
    K3 also with GQA and a ``kv_length`` at a small size, and autograd
    through K1 + K3 against autograd through the plain forward. Returns
    per-kernel results (max error over all cases, times at the training
    shape in bf16)."""
    import torch.nn.functional as F

    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.ops import flash_attention as fa
    from dynamic_llava_tpu_torch.ops.flash_policy import (
        flash_policy_attention, flash_policy_attention_plain)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)

    def randn(*shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            dev, dtype)

    names = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv", "flash_policy_attention_fwd")
    res = {n: {"max_abs_err": 0.0} for n in names}

    # K3: every kernel_cases.FLASH_BWD_CASES case (the training shape and the
    # edges of the 64-row tiles, bf16 and fp32), twice for equal bits, with
    # the delta kernel against _delta; timed at the bf16 training shape
    require(kc.TRAIN_SHAPE.sq == TRAIN_TEXT_LEN - 1 + 576 and kc.TRAIN_SHAPE.b == TRAIN_BATCH,
            "kernel_cases.TRAIN_SHAPE is not phase 9's shape")
    for case in kc.FLASH_BWD_CASES:
        try:
            errs = kc.check_flash_bwd_case(case, dev)
        except AssertionError as e:
            raise RuntimeError(str(e)) from e
        tol = FP32_TOL if case.dtype == torch.float32 else BF16_TOL
        log(f"  K3 {case.label} {kc.describe_flash_case(case)}: max_abs_err dq "
            f"{errs['dq']:.3e}, dk {errs['dk']:.3e}, dv {errs['dv']:.3e} (atol=rtol={tol:g}), "
            f"delta {errs['delta']:.3e} (atol=rtol={FP32_TOL:g}), two launches equal: ok")
        for name, key in (("flash_attention_bwd_dq", "dq"), ("flash_attention_bwd_dkv", "dk"),
                          ("flash_attention_bwd_dkv", "dv")):
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], errs[key])
        res["flash_attention_bwd_dq"]["delta_max_abs_err"] = max(
            res["flash_attention_bwd_dq"].get("delta_max_abs_err", 0.0), errs["delta"])
        if case != kc.TRAIN_SHAPE:
            continue
        q, k, v, g, _ = kc.make_flash_inputs(case, dev, seed=1)
        b, s, h, d = q.shape
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        delta = fa.flash_attention_bwd_delta(out, g)
        delta_ms = time_ms(lambda: fa.flash_attention_bwd_delta(out, g), 20)
        delta_plain_ms = time_ms(lambda: fa._delta(out, g), 5)
        # yardstick of the delta kernel: rowsum(dO * O) as one PyTorch call, on
        # the fp32 values the kernel forms from its bf16 inputs
        of, gf = out.float(), g.float()
        delta_lib_ms = time_ms(lambda: torch.linalg.vecdot(gf, of, dim=-1), 20)
        del of, gf
        dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta), 5)
        dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta), 5)
        all_ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, g), 5)
        pms = time_events_ms(
            lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, g), 3)
        # yardstick: the backward of one SDPA call on the same inputs
        ql, kl, vl = (sdpa_layout(t).requires_grad_(True) for t in (q, k, v))
        gl = sdpa_layout(g)
        o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        lms = time_events_ms(
            lambda: torch.autograd.grad(o, (ql, kl, vl), gl, retain_graph=True), 10)
        del o
        # K1 at this shape (its shape in a train step), beside SDPA's forward
        k1_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True), 10)
        with torch.no_grad():
            k1_lib_ms = time_ms(
                lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True), 10)
        log(f"  K1 time at the training shape: kernel {k1_ms:.4f} ms, SDPA is_causal "
            f"{k1_lib_ms:.4f} ms")
        res["flash_attention_fwd_train_shape"] = dict(ms=k1_ms, library_ms=k1_lib_ms)
        pairs = attended_pairs(b, s, s, True)
        rows = 2 * 4 * b * h * s  # lse and delta, fp32
        # bytes: dq reads q, dO, k, v and writes dq; dkv reads the same and
        # writes dk and dv once, in k's type
        dq_b, dq_by = bound_ms(2 * (3 * q.numel() + 2 * k.numel()) + rows, 6 * pairs * d * h)
        dkv_b, dkv_by = bound_ms(2 * (2 * q.numel() + 4 * k.numel()) + rows,
                                 8 * pairs * d * h)
        delta_b, _ = bound_ms(2 * 2 * q.numel() + rows // 2, 2 * q.numel())
        log(f"  K3 time at the training shape: dq {dq_ms:.4f} ms (bound {dq_b:.4f} "
            f"{dq_by}), dkv {dkv_ms:.4f} ms (bound {dkv_b:.4f} {dkv_by}), delta "
            f"{delta_ms:.4f} ms (bound {delta_b:.4f} bytes, plain {delta_plain_ms:.4f}, "
            f"torch.linalg.vecdot on fp32 {delta_lib_ms:.4f}), whole backward {all_ms:.4f} "
            f"ms, plain {pms:.4f} ms, SDPA backward (dq, dk, dv together) {lms:.4f} ms")
        # plain_ms and library_ms are times of the WHOLE backward (all three kernels' work)
        res["flash_attention_bwd_dq"].update(
            ms=dq_ms, plain_ms=pms, library_ms=lms, bound_ms=dq_b, bound_by=dq_by,
            delta_ms=delta_ms, delta_plain_ms=delta_plain_ms, delta_bound_ms=delta_b,
            delta_library_ms=delta_lib_ms, whole_backward_ms=all_ms)
        res["flash_attention_bwd_dkv"].update(
            ms=dkv_ms, plain_ms=pms, library_ms=lms, bound_ms=dkv_b, bound_by=dkv_by)
        del q, k, v, g, out, lse, delta, ql, kl, vl, gl

    # K4: every kernel_cases.POLICY_CASES and POLICY_EDGE_CASES case, twice for
    # equal bits; at the bf16 training shape the error must be that of the
    # output's own rounding (at most twice max |bf16(plain) - plain|)
    name = "flash_policy_attention_fwd"
    for case in kc.POLICY_CASES + kc.POLICY_EDGE_CASES:
        try:
            err, rounding = kc.check_policy_case(case, dev)
        except AssertionError as e:
            raise RuntimeError(str(e)) from e
        tol = FP32_TOL if case.dtype == torch.float32 else BF16_TOL
        log(f"  {kc.describe_policy_case(case)}: max_abs_err={err:.3e} (atol=rtol={tol:g}), "
            "two launches equal: ok")
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        if case.label != "training shape" or case.dtype != torch.bfloat16:
            continue
        log(f"  K4 training shape bf16: max |kernel - plain| {err:.3e}, max |bf16(plain) - "
            f"plain| {rounding:.3e} ({err / rounding:.2f}x, limit 2x)")
        require(err <= 2 * rounding, "K4 training shape: the error is more than twice that of "
                "the output's own bf16 rounding")
        q, k, v, pol = kc.make_policy_inputs(case, dev)
        b, s, h, d = q.shape
        kms = time_ms(lambda: flash_policy_attention(q, k, v, pol), 5)
        pms = time_events_ms(lambda: flash_policy_attention_plain(q, k, v, pol), 3)
        # the wrapper's two kernels apart: the column sum of v, then the main kernel
        split = kernel_ms_by_name(lambda: flash_policy_attention(q, k, v, pol), 5)
        vsum_ms = sum(ms for n, ms in split.items() if "policy_vsum" in n)
        main_ms = sum(ms for n, ms in split.items() if "flash_policy_fwd" in n)
        # beside it, not a yardstick of the same function (no eps terms): SDPA
        # with the causal mask and log(p') as one float mask
        idx = torch.arange(s, device=dev)
        keep = pol[:, None, :].expand(b, s, s).clone()
        keep[:, idx, idx] = 1.0
        mask = keep.log_().masked_fill_(idx[None, :] > idx[:, None], float("-inf"))
        mask = mask[:, None].to(q.dtype)
        del keep
        ql, kl, vl = sdpa_layout(q), sdpa_layout(k), sdpa_layout(v)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask), 5)
        del mask, ql, kl, vl
        pairs = attended_pairs(b, s, s, True)
        bms, bby = bound_ms(2 * (2 * q.numel() + 2 * k.numel()) + 4 * pol.numel(),
                            4 * pairs * d * h + v.numel())
        k1 = res["flash_attention_fwd_train_shape"]["ms"]
        log(f"  K4 time at the training shape: kernel {kms:.4f} ms (column sum {vsum_ms:.4f}, "
            f"main kernel {main_ms:.4f}; {kms / k1:.2f}x K1 at this shape), plain {pms:.4f} "
            f"ms, bound {bms:.4f} ms ({bby})")
        log(f"  SDPA with a causal + log(p') float mask, not the same function (no eps terms): "
            f"{sdpa_ms:.4f} ms")
        res[name].update(ms=kms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=bby,
                         vsum_ms=vsum_ms, main_ms=main_ms, sdpa_log_policy_mask_ms=sdpa_ms,
                         bf16_rounding_err=rounding)
        del q, k, v, pol

    # autograd through K1 + K3 against autograd through the plain forward
    b, s, h, hkv, d = 2, 517, 8, 4, 128
    ins = [randn(b, s, h, d, dtype=torch.float32).requires_grad_(True),
           randn(b, s, hkv, d, dtype=torch.float32).requires_grad_(True),
           randn(b, s, hkv, d, dtype=torch.float32).requires_grad_(True)]
    g = randn(b, s, h, d, dtype=torch.float32)
    got = torch.autograd.grad(fa.flash_attention_vjp(*ins), ins, g)
    want = torch.autograd.grad(fa.flash_attention_plain(*ins), ins, g)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        err = (a - r).abs().max().item()
        ok = torch.allclose(a, r, atol=FP32_TOL, rtol=FP32_TOL)
        log(f"  autograd through K1+K3 vs through the plain forward, {name} "
            f"[B={b} S={s} H={h} Hkv={hkv} d={d} fp32]: max_abs_err={err:.3e} "
            f"(atol=rtol={FP32_TOL:g}) {'ok' if ok else 'FAIL'}")
        require(ok, f"autograd {name}: K1+K3 disagree with the plain forward's gradient")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res


def small_config():
    """A small GQA model (head_dim 64) for the card-against-CPU phases."""
    from dynamic_llava_tpu_torch.config import (
        ClipVisionConfig, LlamaConfig, LlavaConfig, SparseConfig)

    return LlavaConfig(
        text=LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                              num_attention_heads=4, num_key_value_heads=2),
        vision=ClipVisionConfig.tiny(hidden_size=128, intermediate_size=256,
                                     num_attention_heads=2),
        sparse=SparseConfig(d_model=64, nhead=2, dim_feedforward=128, num_layers=1,
                            output_text_len_for_training=8),
    )


def train_batch(cfg, b: int, text_len: int, seed: int = SEED):
    """``(plan, images)``: ``b`` rows of one image and ``text_len - 1`` text
    tokens, the second half of each row supervised."""
    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX
    from dynamic_llava_tpu_torch.constants import IGNORE_INDEX
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch

    rng = np.random.default_rng(seed)
    ids, labels = [], []
    for _ in range(b):
        row = rng.integers(3, cfg.text.vocab_size, size=(text_len,)).astype(np.int64)
        row[2] = IMAGE_TOKEN_INDEX
        lab = row.copy()
        lab[: text_len // 2] = IGNORE_INDEX
        ids.append(row)
        labels.append(lab)
    plan = plan_batch(ids, cfg.num_image_tokens, labels_list=labels)
    size = cfg.vision.image_size
    return plan, rng.standard_normal((b, size, size, 3), dtype=np.float32)


def check_tower_gradient(torch):
    """Phase 3, K1 + K3 under the CLIP tower: the gradient of
    ``encode_images(frozen_tower=False)`` with respect to the tower's
    ``patch_embedding`` on the card (the tower's attention is the autograd
    Function over K1 and K3) against the same gradient on the CPU (plain
    versions), fp32, atol = rtol = 1e-4; under ``no_grad`` the tower launches
    K1 once a layer and K3 never."""
    from dynamic_llava_tpu_torch.models.dynamic import encode_images
    from dynamic_llava_tpu_torch.ops import flash_attention as fa
    from dynamic_llava_tpu_torch.weights import init_llava_params, map_leaves

    cfg = small_config()
    rng = np.random.default_rng(SEED)
    size = cfg.vision.image_size
    pix = torch.from_numpy(rng.standard_normal((2, size, size, 3), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (2, cfg.num_image_tokens, cfg.text.hidden_size), dtype=np.float32))
    cpu = init_llava_params(cfg, torch.Generator().manual_seed(SEED), "cpu", torch.float32)
    grads = {}
    for device in ("cpu", "cuda"):
        params = map_leaves(lambda _, t: t.to(device), cpu)
        leaf = params["vision_tower"]["patch_embedding"].clone().requires_grad_(True)
        params["vision_tower"] = dict(params["vision_tower"], patch_embedding=leaf)
        out = encode_images(params, cfg, pix.to(device), frozen_tower=False)
        grads[device] = torch.autograd.grad((out * g.to(device)).sum(), leaf)[0].cpu()
    err = (grads["cuda"] - grads["cpu"]).abs().max().item()
    top = grads["cpu"].abs().max().item()
    ok = torch.allclose(grads["cuda"], grads["cpu"], atol=FP32_TOL, rtol=FP32_TOL)
    log(f"  CLIP tower gradient w.r.t. patch_embedding, card (K1 + K3) vs CPU: "
        f"max_abs_err={err:.3e}, max |grad| {top:.3e} (atol=rtol={FP32_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok and top > 0, "the tower's gradient on the card disagrees with the CPU's")
    layers = cfg.vision.num_hidden_layers + cfg.vision.select_layer + 1
    before = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches)
    with torch.no_grad():
        encode_images(map_leaves(lambda _, t: t.cuda(), cpu), cfg, pix.cuda())
    rose = (fa.flash_attention.launches - before[0], fa.flash_attention_bwd_dq.launches - before[1])
    require(rose == (layers, 0), f"the tower under no_grad launched K1, K3 {rose} times, not "
            f"({layers}, 0)")


def check_small_train(torch):
    """Phase 4, training: two train steps of the small model on the card
    (kernels K1, K3, K4) against the same two steps on the CPU (plain
    versions), fp32, from the same weights, batch and Gumbel noise. Adam's
    eps is 1e-5 on both sides, so that a gradient that is rounding noise
    around zero does not move its parameter by a whole lr."""
    from dynamic_llava_tpu_torch.train.optimizer import label_params, make_optimizer
    from dynamic_llava_tpu_torch.train.step import batch_from_plan, make_train_step
    from dynamic_llava_tpu_torch.weights import init_llava_params, map_leaves, named_leaves

    cfg = small_config()
    plan, images = train_batch(cfg, 3, 60)
    b, s = plan.token_ids.shape
    gen = torch.Generator().manual_seed(SEED)
    noises = [[torch.rand(shape, generator=gen).clamp_(min=1e-30)
               for shape in ((b, cfg.num_image_tokens, 2), (b, s, 2), (b, s, 2))]
              for _ in range(2)]
    runs = {}
    for device in ("cpu", "cuda"):
        params = init_llava_params(cfg, torch.Generator().manual_seed(SEED), "cpu",
                                   torch.float32)
        params = map_leaves(lambda _, t: t.to(device), params)
        opt = make_optimizer(base_lr=1e-3, predictor_lr=5e-3, weight_decay=0.01, eps=1e-5)
        step = make_train_step(cfg, opt, labels=label_params(params))
        state = opt.init(params)
        batch = batch_from_plan(plan, images, device)
        losses = []
        for noise in noises:
            _, _, metrics = step(params, state, batch, [u.to(device) for u in noise], 0.8)
            losses.append({k: float(v) for k, v in metrics.items()})
        runs[device] = (losses, {p: t.cpu() for p, t in named_leaves(params)})
    for i, (lc, lg) in enumerate(zip(runs["cpu"][0], runs["cuda"][0])):
        log(f"  small train step {i + 1}: card {lg} | CPU {lc}")
        for k in lc:
            require(abs(lg[k] - lc[k]) <= 1e-3 * abs(lc[k]) + 1e-6,
                    f"small train step {i + 1}: {k} card {lg[k]} != CPU {lc[k]} (rtol 1e-3)")
    worst = max(((runs["cuda"][1][p] - t).abs().max().item(), p)
                for p, t in runs["cpu"][1].items())
    log(f"  small train: max parameter difference after 2 steps {worst[0]:.3e} at "
        f"{worst[1]} (atol 1e-4)")
    require(worst[0] <= 1e-4, f"small train: parameters differ by {worst[0]} at {worst[1]}")


def train(torch, params, cfg, label, expect):
    """TRAIN_STEPS steps of ``Trainer.train`` on ``params`` (updated in
    place) with the launch counters of K1, K3 and K4 zeroed before and held
    against ``expect`` after. Returns the measurements."""
    import tempfile

    from dynamic_llava_tpu_torch.ops import flash_attention as fa
    from dynamic_llava_tpu_torch.ops.flash_policy import flash_policy_attention
    from dynamic_llava_tpu_torch.train.trainer import Trainer, TrainerConfig
    from dynamic_llava_tpu_torch.weights import named_leaves

    counters = {"flash_attention_fwd": fa.flash_attention,
                "flash_attention_bwd_delta": fa.flash_attention_bwd_delta,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                "flash_policy_attention_fwd": flash_policy_attention}
    plan, images = train_batch(cfg, TRAIN_BATCH, TRAIN_TEXT_LEN)
    b, s = plan.token_ids.shape
    # leaves that must move. (A norm weight of 1.0 does not, in bf16: the
    # base lr of 5e-6 is far below half an ulp of 1.0.) The predictors get a
    # gradient only while they are on.
    probes = ["llm/layers/q", "llm/embed", "mm_projector/[0]/w"]
    if cfg.sparse.use_output_text_predictor:
        probes.append("predictors/output_text_score_predictor/fc1/w")
    leaves = dict(named_leaves(params))
    before = {p: leaves[p].float().sum().item() for p in probes}
    frozen_before = leaves["vision_tower/class_embedding"].clone()

    with tempfile.TemporaryDirectory() as out_dir:
        # warmup 1 step of 100: the first step runs at lr 0, as in the JAX trainer
        tc = TrainerConfig(output_dir=out_dir, num_train_steps=100, warmup_ratio=0.01,
                           logging_steps=1, save_steps=0, report_to="none", seed=SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, params, tc)
        for fn in counters.values():
            fn.launches = 0
        times, losses = [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.train([(plan, images)])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(metrics)
        got = {n: fn.launches for n, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        del trainer
    want = {n: c * TRAIN_STEPS for n, c in expect.items()}
    require(got == want, f"{label}: launches {got} != {want} (the layer layout's counts)")
    for i, m in enumerate(losses):
        require(all(np.isfinite(v) for v in m.values()), f"{label} step {i + 1}: {m}")
    after = {p: leaves[p].float().sum().item() for p in probes}
    require(all(after[p] != before[p] for p in probes),
            f"{label}: parameters did not change: {before} -> {after}")
    require(torch.equal(leaves["vision_tower/class_embedding"], frozen_before),
            f"{label}: a frozen leaf changed")
    step_s = sum(times[1:]) / len(times[1:])
    r = dict(first_step_s=times[0], step_ms=step_s * 1e3, tok_s=b * s / step_s,
             peak_gib=peak, depth=cfg.text.num_hidden_layers, launches=got)
    keys = ("loss", "lm_loss", "image_mask_loss", "output_text_mask_loss", "grad_norm")
    log(f"  {label}: depth {r['depth']}, B={b}, S={s}; first step {times[0]:.3f} s, then "
        f"{r['step_ms']:.1f} ms/step ({r['tok_s']:.1f} tok/s), peak {peak:.2f} GiB; "
        f"launches {got}; "
        + "; ".join(f"step {i + 1} " + " ".join(f"{k}={m[k]:.4f}" for k in keys if k in m)
                    for i, m in enumerate(losses)))
    return r


def check_small_model(torch):
    """Phase 4: greedy generation of a small GQA model (head_dim 64) on the
    card (kernels, fp32) must match the port's plain CPU path token for
    token, with plain, int8 and int4 decoder weights; then the lean modes
    (int8 and fp8 KV caches, ring overflow past both tiers' wrap, int4
    weights with the fused MLP, and that with an int8 cache). In a lean
    mode a stored byte or a bf16 ``h`` may round the other way on the card
    (its fp32 sums run in another order), so there the logits of every step
    are held under teacher forcing with the CPU's tokens (atol 5e-2; ring
    with its fp32 cache 1e-3 and token for token), and whether the free
    runs agree token for token is logged."""
    import os

    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX
    from dynamic_llava_tpu_torch.generation.generate import (
        GenerationConfig, Generator)
    from dynamic_llava_tpu_torch.models.dynamic import decode_step
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
    from dynamic_llava_tpu_torch.ops.quant import quantize_llm_params
    from dynamic_llava_tpu_torch.weights import init_llava_params, map_leaves

    cfg = small_config()
    rng = np.random.default_rng(SEED)
    ids = [np.concatenate([rng.integers(3, 500, 7), [IMAGE_TOKEN_INDEX],
                           rng.integers(3, 500, 9 + i)]) for i in range(3)]
    pix = rng.standard_normal((3, 56, 56, 3), dtype=np.float32)
    base = dict(max_new_tokens=16, cache_dtype="float32", pad_multiple=8, decode_chunk=8,
                eos_token_id=-1)

    def make(bits):
        cpu_params = init_llava_params(cfg, torch.Generator().manual_seed(SEED), "cpu",
                                       torch.float32)
        if bits:
            quantize_llm_params(cpu_params, bits=bits)
        return cpu_params, map_leaves(lambda _, t: t.cuda(), cpu_params)

    for bits in (None, 8, 4):
        cpu_params, gpu_params = make(bits)
        gc = GenerationConfig(**base)
        want = Generator(cpu_params, cfg, gc).generate(ids, pix)
        got = Generator(gpu_params, cfg, gc).generate(ids, pix)
        kind = f"int{bits}" if bits else "fp32"
        log(f"  small model ({kind} weights) tokens (card): {got}")
        require(got == want,
                f"small model {kind}: card tokens {got} != plain CPU {want}")
        log(f"  small model ({kind} weights): card == plain CPU path, token for token")

    def forced_logits(gen, gc, tokens):
        """Prefill and one decode step per token of ``tokens`` (teacher
        forcing): the logits of every step, on the host."""
        plan = plan_batch(ids, cfg.num_image_tokens, pad_multiple=gc.pad_multiple)
        steps = len(tokens[0])
        with torch.inference_mode():
            state, _ = gen.prefill_from_plan(plan, pix, steps)
            logits = [state.last_logits]
            for i in range(steps):
                tok = torch.tensor([o[i] for o in tokens], device=gen.device)
                state = decode_step(gen.params, cfg, tok, state, kv_overflow=gc.kv_overflow)
                logits.append(state.last_logits)
        return torch.stack(logits).float().cpu()

    lean = [
        ("int8 KV", None, dict(cache_dtype="int8"), False, 5e-2),
        ("fp8 KV", None, dict(cache_dtype="float8_e4m3fn"), False, 5e-2),
        ("ring overflow", None, dict(kv_overflow="ring", kv_window=2, max_new_tokens=40),
         False, 1e-3),
        ("int4 weights, fused MLP", 4, {}, True, 5e-2),
        ("int4 weights, fused MLP, int8 KV", 4, dict(cache_dtype="int8"), True, 5e-2),
    ]
    for label, bits, over, fused, tol in lean:
        cpu_params, gpu_params = make(bits)
        gc = GenerationConfig(**dict(base, **over))
        os.environ.pop(Q4_MLP_SWITCH, None)
        if fused:
            os.environ[Q4_MLP_SWITCH] = "1"
        try:
            cpu_gen, gpu_gen = Generator(cpu_params, cfg, gc), Generator(gpu_params, cfg, gc)
            want = cpu_gen.generate(ids, pix)
            got = gpu_gen.generate(ids, pix)
            ref, out = forced_logits(cpu_gen, gc, want), forced_logits(gpu_gen, gc, want)
        finally:
            os.environ.pop(Q4_MLP_SWITCH, None)
        err = (out - ref).abs().max().item()
        same = got == want
        log(f"  small model ({label}): logits of {out.shape[0]} steps card vs plain CPU "
            f"path max_abs_err={err:.3e} (atol {tol:g}); free-running tokens "
            f"{'equal' if same else 'differ'}: {got}")
        require(bool(torch.isfinite(out).all()) and err <= tol,
                f"small model {label}: logits differ by {err} (atol {tol})")
        require(same or tol > 1e-3, f"small model {label}: card tokens {got} != CPU {want}")


Q4_MLP_SWITCH = "DYNAMIC_LLAVA_Q4_MLP"


def cache_bytes(cache) -> int:
    """Bytes of a tiered KV cache: K, V and the int8 mode's scales."""
    return sum(t.numel() * t.element_size()
               for tier in (cache.pre, cache.post)
               for t in (tier.k, tier.v, tier.k_scale, tier.v_scale) if t is not None)


def eager_decode(torch, gen, plan, pix, steps):
    """The graph's reference: prefill, then ``steps`` greedy decode steps as
    an eager loop of ``argmax`` + ``decode_step`` on the card, one launch at
    a time. Returns (``[steps, B]`` tokens, step wall ms, the serving
    kernels' wrapper calls of the prefill and the steps by
    ``kernel_cases.SERVING_KERNELS`` label)."""
    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.models.dynamic import decode_step

    before = kc.read_counters()
    with torch.inference_mode():
        state, _ = gen.prefill_from_plan(plan, pix, steps)
        toks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = torch.argmax(state.last_logits, dim=-1)
            state = decode_step(gen.params, gen.cfg, tok, state,
                                kv_overflow=gen.gen_cfg.kv_overflow)
            toks.append(tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
    calls = kc.wrapper_calls(before, kc.read_counters())
    return torch.stack(toks).cpu().numpy(), step_ms, calls


def graph_decode(torch, gen, plan, pix, steps):
    """The graph side, timed as ``eager_decode`` times the eager loop:
    prefill into the ``Generator``'s runner, then the host clock around its
    chunks (replays of the captured step; chunk k+1 enqueued before chunk
    k's tokens are read, as ``generate`` does) up to the last chunk's
    tokens. Returns (``[steps, B]`` tokens, step wall ms)."""
    with torch.inference_mode():
        state, _ = gen.prefill_from_plan(plan, pix, steps)
        runner = gen.runner(plan, pix, steps)
        runner.load(state, 0)
        del state
        n = steps // runner.chunk
        toks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = runner.run_chunk()
        for ci in range(n):
            following = runner.run_chunk() if ci + 1 < n else None
            toks.append(pending.tokens())
            pending = following
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
    return np.concatenate(toks), step_ms


def serve(torch, params, modes, counters, need, label, b=8, max_new=64, n_text=60,
          batches=2):
    """For each mode of ``modes`` on the same weights, the main path:
    ``batches`` batches of ``b`` requests (one image and ``n_text`` text
    tokens each, the same prompts for every call) through
    ``Generator.generate``, with every wrapper's count in ``counters``
    (name -> wrapper) zeroed just before and read just after, and the
    serving kernels' launches on the card counted in a profiler trace of
    those calls (``kernel_cases.device_launches``). A mode is ``(name,
    cfg)`` or ``(name, cfg, opts)``: ``opts["gen"]`` are
    ``GenerationConfig`` fields (``cache_dtype``, ``kv_overflow``,
    ``kv_window``), ``opts["fused"]`` switches the fused int4 MLP (K9) on
    for the mode. Every wrapper named in ``need`` must be called in each
    mode (K9 only with the switch on); on the card K2 must launch once per
    layer and decode step, K9 as often with the switch on and never with it
    off, and every serving kernel as often as the wrappers of an eager loop
    (``eager_decode``) launch it for the same prefill and steps. Then, apart
    from the counts and the trace: ``TIMED`` more ``generate`` calls timed, the prefill
    timed alone (TTFT), the graph's and the eager loop's step walls, and the
    graph's tokens held against the eager loop's. Returns the per-mode
    measurements."""
    import os

    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.models.dynamic import gen_cache_sizes
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch

    cfg0 = modes[0][1]
    rng = np.random.default_rng(SEED)
    vocab, size = cfg0.text.vocab_size, cfg0.vision.image_size
    ids = [np.concatenate([rng.integers(3, vocab, n_text // 2), [IMAGE_TOKEN_INDEX],
                           rng.integers(3, vocab, n_text - n_text // 2)])
           for _ in range(b)]
    pix = rng.standard_normal((b, size, size, 3), dtype=np.float32)
    results = {}
    for mode, cfg, *rest in modes:
        opts = rest[0] if rest else {}
        fused = bool(opts.get("fused"))
        # eos -1: every request runs to max_new, so each run does the same work
        gc = GenerationConfig(max_new_tokens=max_new, temperature=0.0, eos_token_id=-1,
                              **opts.get("gen", {}))
        plan = plan_batch(ids, cfg0.num_image_tokens, pad_multiple=gc.pad_multiple)
        chunk = max(1, min(gc.decode_chunk, max_new))
        steps = -(-max_new // chunk) * chunk  # decode steps of one generate call
        gen = Generator(params, cfg, gc)
        sizes = gen_cache_sizes(cfg, plan.seq_len, steps, bucket=gc.pad_multiple,
                                decode_window=gc.kv_window, ring=gc.kv_overflow == "ring")
        os.environ.pop(Q4_MLP_SWITCH, None)
        if fused:
            os.environ[Q4_MLP_SWITCH] = "1"
        try:
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # the main path (the first call captures the decode step); one
            # trace a call keeps the profiler's buffers small
            outs, per_call = [], []
            for _ in range(batches):
                out, seen = kc.device_launches(lambda: gen.generate(ids, pix))
                outs.append(out)
                per_call.append(seen)
            device = {k: sum(c[k] for c in per_call) for k in kc.SERVING_KERNELS}
            calls = {name: fn.launches for name, fn in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            runner = gen.decode_runner
            # timed apart from the trace: TIMED calls and as many prefills
            # alone, the median of each kept (the host's pace varies)
            e2es, ttfts = [], []
            for _ in range(TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(gen.generate(ids, pix))
                torch.cuda.synchronize()
                e2es.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                with torch.inference_mode():
                    state, info = gen.prefill_from_plan(plan, pix, steps)
                torch.cuda.synchronize()
                ttfts.append(time.perf_counter() - t0)
            e2e, ttft = statistics.median(e2es), statistics.median(ttfts)
            require(bool(torch.isfinite(state.last_logits).all()),
                    f"{label} {mode}: non-finite prefill logits")
            kv_gib, kv_dtype = cache_bytes(state.cache) / 2**30, state.cache.pre.k.dtype
            tiers = (state.cache.pre.max_len, state.cache.post.max_len)
            del state
            # the graph's tokens and step wall against the eager loop's, all steps
            require(gen.decode_runner is runner and runner.graph is not None,
                    f"{label} {mode}: decode took no CUDA graph, or not one graph")
            graph_toks, graph_ms = graph_decode(torch, gen, plan, pix, steps)
            eager_toks, eager_ms, eager_calls = eager_decode(torch, gen, plan, pix, steps)
        finally:
            os.environ.pop(Q4_MLP_SWITCH, None)
        for name in need:
            wanted = fused or name != "q4_mlp"
            require((calls[name] > 0) == wanted,
                    f"{label} {mode}: {name}'s wrapper called {calls[name]} times ({calls})")
        per_layer = batches * steps * cfg.text.num_hidden_layers
        require(device["decode_kernel"] == per_layer,
                f"{label} {mode}: K2 launched {device['decode_kernel']} times on the card, "
                f"not {per_layer} (by call {per_call}; eager loop {eager_calls})")
        require(device["q4_mlp_kernel"] == (per_layer if fused else 0),
                f"{label} {mode}: K9 launched {device['q4_mlp_kernel']} times on the card "
                f"with the switch {'on' if fused else 'off'} (by call {per_call})")
        require(all(c == eager_calls for c in per_call),
                f"{label} {mode}: launches on the card by call {per_call} != the eager "
                f"loop's wrapper calls {eager_calls}")
        out = outs[-1]
        require(all(o == out for o in outs),
                f"{label} {mode}: batches of the same prompts differ")
        require(len(out) == b and all(len(o) == max_new for o in out),
                f"{label} {mode}: wrong output lengths")
        require(all(0 <= t < vocab for o in out for t in o),
                f"{label} {mode}: token id out of range")
        new_len = info.new_length.tolist()
        want_len = [int(v) - (cfg.num_image_tokens - cfg.vision_keep_budget)
                    for v in plan.valid_len]
        require(new_len == want_len,
                f"{label} {mode}: new_length {new_len} != {want_len}")
        require(tiers == sizes, f"{label} {mode}: tier capacities")
        tok_s = b * max_new / (e2e - ttft)
        same = bool(np.array_equal(np.asarray(out).T, eager_toks[:max_new])
                    and np.array_equal(graph_toks, eager_toks))
        graph = dict(eager_step_ms=eager_ms, graph_step_ms=graph_ms,
                     capture_ms=runner.capture_ms, tokens_equal=same)
        require(same, f"{label} {mode}: graph tokens differ from the eager loop's")
        results[mode] = dict(e2e_s=e2e, ttft_ms=ttft * 1e3, decode_tok_s=tok_s,
                             peak_gib=peak, kv_gib=kv_gib, pre=sizes[0], post=sizes[1],
                             launches=calls, device_launches=device, graph=graph)
        log(f"  {label} {mode}: B={b}, prompt length {plan.seq_len}, {max_new} new tokens, "
            f"tier capacities pre={sizes[0]} post={sizes[1]}, KV cache "
            f"{kv_dtype} {kv_gib:.3f} GiB; generate {e2e:.3f} s, TTFT "
            f"{ttft * 1e3:.1f} ms, decode {tok_s:.1f} tok/s, peak {peak:.2f} GiB, "
            f"new_length {new_len[:2]}... (prompt {plan.valid_len.tolist()[:2]}...), "
            f"wrapper calls {calls}, launches on the card {device}, "
            f"first tokens {out[0][:8]}")
        log(f"  {label} {mode}: decode step wall {eager_ms:.3f} ms eager, "
            f"{graph_ms:.3f} ms graph (capture {runner.capture_ms:.1f} ms); "
            "graph tokens == eager loop's")
        del gen, runner, info
    return results


def main() -> int:
    if not (ROOT / "dynamic_llava_tpu_torch" / "csrc").is_dir():
        raise SystemExit(
            "chip_smoke.py: run it from a checkout of the repository "
            "(dynamic_llava_tpu_torch/ not found beside it)"
        )
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dynamic_llava_tpu_torch import kernels
    from dynamic_llava_tpu_torch.config import (
        DENSE_SPARSE_CONFIG, LlamaConfig, LlavaConfig)
    from dynamic_llava_tpu_torch.ops.decode_attention import decode_attention
    from dynamic_llava_tpu_torch.ops import quant_matmul as qm
    from dynamic_llava_tpu_torch.ops.flash_attention import flash_attention
    from dynamic_llava_tpu_torch.ops.quant import (
        init_quantized_llama_params, quantize_llm_params)
    from dynamic_llava_tpu_torch.weights import init_llava_params, param_bytes

    log("phase 2: build")
    t0 = time.perf_counter()
    lib = kernels.load_library()
    log(f"  built {lib.path.name} in {lib.build_seconds:.1f} s "
        f"(load_library {time.perf_counter() - t0:.1f} s)")
    entry, spilled = "", []
    for line in lib.ptxas_log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log(f"  {line.strip()}")
            if "Compiling" in line:
                entry = line.split("'")[1]
        elif "spill stores" in line:
            log(f"    {line.strip()}")
            if "0 bytes spill stores, 0 bytes spill loads" not in line:
                spilled.append(entry)
    # the tensor-core attention kernels, the decode-attention kernel, the bf16
    # GEMV kernel and the fused MLP hold their accumulators in registers
    no_spills = ("mma_kernel", "decode_kernel", "gemv_tc_kernel", "q4_mlp_kernel")
    require(not [e for e in spilled if any(k in e for k in no_spills)],
            f"ptxas spilled registers in {spilled}")

    log("phase 3: kernels against their plain versions")
    kres = check_kernels(torch)
    kres["decode_attention_appended"] = check_decode_kernel(torch)
    kres.update(check_train_kernels(torch))
    kres["flash_attention_fwd"]["train_shape"] = kres.pop("flash_attention_fwd_train_shape")
    kres.update(check_quant_kernels(torch))
    kres["q4_mlp"] = check_mlp_kernel(torch)
    check_tower_gradient(torch)

    log("phase 4: small model, card against plain CPU path")
    check_small_model(torch)
    check_small_train(torch)

    counters = {"flash_attention_fwd": flash_attention,
                "decode_attention_appended": decode_attention,
                "q8_gemv": qm.q8_gemv, "q8_gemv_group": qm.q8_gemv_group,
                "q4_gemv": qm.q4_gemv, "q4_gemv_group": qm.q4_gemv_group,
                "q4_mlp": qm.q4_mlp}
    # the kernels each path must launch; the JSON line reports each
    # kernel's launches in the path named here
    paths = {"bf16": ("flash_attention_fwd", "decode_attention_appended"),
             "int8": ("q8_gemv", "q8_gemv_group"),
             "int4": ("q4_gemv", "q4_gemv_group", "q4_mlp"),
             "lean": ("q4_gemv", "q4_gemv_group", "q4_mlp"),
             "ring": ("q4_gemv", "q4_gemv_group", "q4_mlp"),
             "13b": ("q4_gemv", "q4_gemv_group", "q4_mlp")}
    # the JSON line reports a kernel's launches in the path named here
    reported = {"bf16": ("flash_attention_fwd", "decode_attention_appended"),
                "int8": ("q8_gemv", "q8_gemv_group"), "int4": ("q4_gemv", "q4_gemv_group"),
                "lean": ("q4_mlp",)}
    # a serving wrapper -> the kernel it launches (kernel_cases.SERVING_KERNELS);
    # a GEMV wrapper and its group form launch the same kernel
    kernel_of = {"flash_attention_fwd": "flash_fwd", "decode_attention_appended": "decode_kernel",
                 "q8_gemv": "gemv int8", "q8_gemv_group": "gemv int8",
                 "q4_gemv": "gemv int4", "q4_gemv_group": "gemv int4",
                 "q4_mlp": "q4_mlp_kernel"}
    launches, calls, results = {}, {}, {}

    def drive(label, params, modes, **kw):
        need = ("flash_attention_fwd", "decode_attention_appended") + paths[label]
        results[label] = serve(torch, params, modes, counters, need, label, **kw)
        runs = results[label].values()
        host = {n: sum(r["launches"][n] for r in runs) for n in counters}
        device = {k: sum(r["device_launches"][k] for r in runs) for k in set(kernel_of.values())}
        for n in reported.get(label, ()):
            launches[n], calls[n] = device[kernel_of[n]], host[n]
        log(f"  {label} path: wrapper calls {host}, launches on the card {device}")

    cfg_sparse = LlavaConfig()
    cfg_dense = LlavaConfig(sparse=DENSE_SPARSE_CONFIG)
    both = [("sparse", cfg_sparse), ("dense", cfg_dense)]
    dev = torch.device("cuda")

    log("phase 5: LLaVA-1.5-7B width, random bf16 weights, sparse and dense")
    t0 = time.perf_counter()
    params = init_llava_params(
        cfg_sparse, torch.Generator(device=dev).manual_seed(SEED), dev, torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  params: {param_bytes(params) / 2**30:.2f} GiB "
        f"(decoder {param_bytes(params['llm']) / 2**30:.2f}) in "
        f"{time.perf_counter() - t0:.1f} s")
    drive("bf16", params, both)
    # K1 once a tower layer and decoder layer per prefill (two batches, sparse
    # and dense): the differentiable tower costs serving no launch
    vis = cfg_sparse.vision
    per_prefill = (vis.num_hidden_layers + vis.select_layer + 1
                   + cfg_sparse.text.num_hidden_layers)
    require(launches["flash_attention_fwd"] == calls["flash_attention_fwd"]
            == 2 * 2 * per_prefill,
            f"bf16 path: K1 launched {launches['flash_attention_fwd']} times "
            f"({calls['flash_attention_fwd']} wrapper calls), not {2 * 2 * per_prefill}")

    log("phase 6: quantized serving at 7B width")
    t0 = time.perf_counter()
    quantize_llm_params(params, bits=8)
    torch.cuda.synchronize()
    log(f"  int8: decoder quantized in place in {time.perf_counter() - t0:.1f} s, "
        f"{param_bytes(params['llm']) / 2**30:.2f} GiB (all params "
        f"{param_bytes(params) / 2**30:.2f} GiB)")
    drive("int8", params, both)
    del params["llm"]
    torch.cuda.empty_cache()
    params["llm"] = init_quantized_llama_params(
        cfg_sparse.text, torch.Generator(device=dev).manual_seed(SEED), dev, bits=4)
    torch.cuda.synchronize()
    log(f"  int4: decoder made directly, {param_bytes(params['llm']) / 2**30:.2f} GiB "
        f"(all params {param_bytes(params) / 2**30:.2f} GiB)")
    drive("int4", params, both[:1])

    log("phase 7: lean-memory serving at 7B width on the int4 decoder: the fused MLP "
        "(K9) off and on, int8 and fp8 KV caches, ring overflow")
    int8kv, fp8kv = dict(cache_dtype="int8"), dict(cache_dtype="float8_e4m3fn")
    # two-kernel, fused, fused, two-kernel: the host's pace drifts within a call
    drive("lean", params, [
        ("sparse bf16-KV two-kernel MLP", cfg_sparse),
        ("sparse bf16-KV fused MLP", cfg_sparse, dict(fused=True)),
        ("sparse bf16-KV fused MLP, again", cfg_sparse, dict(fused=True)),
        ("sparse bf16-KV two-kernel MLP, again", cfg_sparse),
        ("sparse int8-KV fused MLP", cfg_sparse, dict(fused=True, gen=int8kv)),
        ("dense int8-KV fused MLP", cfg_dense, dict(fused=True, gen=int8kv)),
        ("sparse fp8-KV fused MLP", cfg_sparse, dict(fused=True, gen=fp8kv)),
    ])
    # 256 new tokens at a decode window of 64: both tiers wrap
    ring = dict(cache_dtype="int8", kv_overflow="ring", kv_window=64)
    drive("ring", params, [("sparse int8-KV fused MLP, 256 new tokens", cfg_sparse,
                            dict(fused=True, gen=ring))], max_new=256)
    del params["llm"]
    torch.cuda.empty_cache()

    log("phase 8: LLaVA-1.5-13B width (40 layers, hidden 5120, ffn 13824), int4 decoder "
        "made directly, fused MLP, B=1, 256 new tokens")
    text13 = LlamaConfig.llama_13b()
    cfg13 = LlavaConfig(text=text13)
    # tower, projector and predictors at the 13B decoder's width, without a
    # bf16 decoder (26 GB that the int4 path never holds)
    params = init_llava_params(
        dataclasses.replace(cfg13, text=dataclasses.replace(text13, num_hidden_layers=0)),
        torch.Generator(device=dev).manual_seed(SEED + 2), dev, torch.bfloat16)
    params["llm"] = init_quantized_llama_params(
        text13, torch.Generator(device=dev).manual_seed(SEED + 2), dev, bits=4)
    torch.cuda.synchronize()
    log(f"  13B int4: decoder {param_bytes(params['llm']) / 2**30:.2f} GiB (all params "
        f"{param_bytes(params) / 2**30:.2f} GiB)")
    drive("13b", params, [
        ("sparse", cfg13, dict(fused=True)),
        ("dense", LlavaConfig(text=text13, sparse=DENSE_SPARSE_CONFIG), dict(fused=True)),
    ], b=1, max_new=256)
    del params
    torch.cuda.empty_cache()

    log(f"phase 9: training at LLaVA-1.5-7B width, {TRAIN_DEPTH} decoder layers, "
        "sparse steps, then dense-stage steps on the same weights")
    depth = TRAIN_DEPTH
    train_sparse = dataclasses.replace(
        cfg_sparse, text=dataclasses.replace(cfg_sparse.text, num_hidden_layers=depth))
    train_dense = dataclasses.replace(train_sparse, sparse=DENSE_SPARSE_CONFIG)
    params = init_llava_params(
        train_sparse, torch.Generator(device=dev).manual_seed(SEED + 1), dev, torch.bfloat16)
    # per step: the CLIP tower (to layer -2) runs K1 forward only; a decoder
    # layer under remat runs its attention forward twice and its backward once
    clip_layers = train_sparse.vision.num_hidden_layers + train_sparse.vision.select_layer + 1
    sl = train_sparse.sparse.sparse_layer
    expect = {
        "sparse": {"flash_attention_fwd": clip_layers + 2 * sl, "flash_attention_bwd_delta": sl,
                   "flash_attention_bwd_dq": sl, "flash_attention_bwd_dkv": sl,
                   "flash_policy_attention_fwd": 2 * (depth - sl)},
        "dense": {"flash_attention_fwd": clip_layers + 2 * depth,
                  "flash_attention_bwd_delta": depth,
                  "flash_attention_bwd_dq": depth, "flash_attention_bwd_dkv": depth,
                  "flash_policy_attention_fwd": 0},
    }
    results["train"] = {
        "sparse": train(torch, params, train_sparse, "train sparse", expect["sparse"]),
        "dense": train(torch, params, train_dense, "train dense", expect["dense"]),
    }
    # K3 and K4 report their launches on the sparse path, where all three run
    # (eager: one launch a wrapper call)
    for n in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv", "flash_policy_attention_fwd"):
        launches[n] = calls[n] = results["train"]["sparse"]["launches"][n]
    del params
    require("jax" not in sys.modules and "dynamic_llava_tpu" not in sys.modules,
            "jax or the JAX package was imported")
    for label, runs in results.items():
        for mode, r in runs.items():
            if label == "train":
                log(f"  summary train {mode}: depth {r['depth']}, {r['step_ms']:.1f} ms/step, "
                    f"{r['tok_s']:.1f} tok/s, peak {r['peak_gib']:.2f} GiB")
                continue
            log(f"  summary {label} {mode}: TTFT {r['ttft_ms']:.1f} ms, decode "
                f"{r['decode_tok_s']:.1f} tok/s, peak {r['peak_gib']:.2f} GiB, KV cache "
                f"{r['kv_gib']:.3f} GiB")

    for name in ("q8_gemv", "q8_gemv_group", "q4_gemv", "q4_gemv_group"):
        r = kres[name]
        log(f"  {name}: max_abs_err {r['max_abs_err']:.3e}, max err / max|ref| "
            f"{r['max_err_rel']:.3e} over all shapes and rows; kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms at {r['shape']}")
    csrc = "dynamic_llava_tpu_torch/csrc/"
    table = {
        "flash_attention_fwd": (csrc + "flash_attention_fwd.cu",
                                "dynamic_llava_tpu/ops/flash_attention.py:38"),
        "decode_attention_appended": (csrc + "decode_attention.cu",
                                      "dynamic_llava_tpu/ops/decode_attention.py:29"),
        "flash_attention_bwd_dkv": (csrc + "flash_attention_bwd.cu",
                                    "dynamic_llava_tpu/ops/flash_attention.py:303"),
        "flash_attention_bwd_dq": (csrc + "flash_attention_bwd.cu",
                                   "dynamic_llava_tpu/ops/flash_attention.py:365"),
        "flash_policy_attention_fwd": (csrc + "flash_policy_fwd.cu",
                                       "dynamic_llava_tpu/ops/flash_policy.py:34"),
        "q8_gemv": (csrc + "quant_gemv.cu", "dynamic_llava_tpu/ops/quant_matmul.py:226"),
        "q8_gemv_group": (csrc + "quant_gemv.cu",
                          "dynamic_llava_tpu/ops/quant_matmul.py:376"),
        "q4_gemv": (csrc + "quant_gemv.cu", "dynamic_llava_tpu/ops/quant_matmul.py:46"),
        "q4_gemv_group": (csrc + "quant_gemv.cu",
                          "dynamic_llava_tpu/ops/quant_matmul.py:538"),
        "q4_mlp": (csrc + "quant_mlp.cu", "dynamic_llava_tpu/ops/quant_matmul.py:706"),
    }
    # beside the required keys: K2's int8 and fp8 storage readings and its
    # other shapes, every GEMV shape's readings by rows, K9's
    # two-kernel time (K8 + silu*mul + K7) and 13B-shape readings, K1's CLIP
    # shape and full-length readings, K3's delta kernel and whole backward
    extra = {"decode_attention_appended": ("int8", "fp8", "shapes"),
             "q8_gemv": ("shapes",), "q8_gemv_group": ("shapes",),
             "q4_gemv": ("shapes",), "q4_gemv_group": ("shapes",),
             "q4_mlp": ("two_kernel_ms", "shapes"),
             "flash_policy_attention_fwd": ("vsum_ms", "main_ms", "sdpa_log_policy_mask_ms",
                                            "bf16_rounding_err"),
             "flash_attention_fwd": ("full_length_ms", "library_full_length_ms", "clip",
                                     "train_shape"),
             "flash_attention_bwd_dq": ("delta_ms", "delta_plain_ms", "delta_bound_ms",
                                        "delta_library_ms", "delta_max_abs_err",
                                        "whole_backward_ms")}
    # the launches of a GEMV wrapper and its group form are one kernel's
    shared = {"q8_gemv": "q8_gemv_group", "q8_gemv_group": "q8_gemv",
              "q4_gemv": "q4_gemv_group", "q4_gemv_group": "q4_gemv"}
    print("decode_graph " + json.dumps({
        f"{label} {mode}": r["graph"] for label, runs in results.items() if label != "train"
        for mode, r in runs.items()}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": kres[name]["max_abs_err"],
         "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"],
         "bound_ms": kres[name]["bound_ms"], "bound_by": kres[name]["bound_by"],
         "library_ms": kres[name]["library_ms"], "wrapper_calls": calls[name],
         **({"launches_shared_with": shared[name]} if name in shared else {}),
         **{k: kres[name][k] for k in extra.get(name, ())}}
        for name, (source, replaces) in table.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
