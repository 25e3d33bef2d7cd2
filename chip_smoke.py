#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card, ``nvcc`` and
about 25 GB of device memory, and fails (exit code != 0, no result line)
anywhere else. Phases, each of which raises on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``dynamic_llava_tpu_torch/csrc``
   with ``nvcc`` for ``sm_90a`` and print the build time and ``ptxas``
   resource lines;
3. hold each kernel against its plain PyTorch version at the shapes of the
   main path, timing both with CUDA events on a CUDA-graph replay. K1/K2: bf16 inputs against the
   plain version in fp32 on the same values, atol = rtol = 2e-2 for bf16
   output rounding; fp32 inputs at atol = rtol = 1e-4. K5-K8 (int8 / int4
   GEMVs) at the 7B decoder's shapes and rows 1, 8, 24, 64: max abs error
   relative to max |ref| within 1e-2 for bf16 outputs, 1e-4 for the fp32
   lm_head; the weights rotate through copies larger than the 50 MB L2, as
   a decode step finds them cold;
4. a small model (head_dim 64, GQA) generated greedily on the card through
   the kernels, in fp32 with plain, int8 and int4 weights, must give the
   same tokens as the port's plain CPU path, which the CPU tests hold
   token-exact against the JAX package;
5. the main path at LLaVA-1.5-7B width (32 layers, random bf16 weights made
   on the card from a seed): two batches of 8 requests (one 336x336 image
   and 60 text tokens each, 64 new tokens, greedy) through
   ``Generator.generate``, sparse and then dense, with the kernels' launch
   counters zeroed before and read after;
6. quantized serving at 7B width, the same batches: the phase-5 weights
   quantized in place to int8 (``quantize_llm_params``), sparse and dense;
   then an int4 decoder made directly (``init_quantized_llama_params``)
   beside the bf16 tower, projector and predictors, sparse. Each path's
   launch counters are zeroed before it and read after.

The second batch of each mode is timed (the first carries first-call
costs: library and cuBLAS set-up); TTFT is the same prefill timed again
alone, and decode tok/s is ``B * 64 / (batch time - TTFT)``. The last two
lines of standard output are a JSON object with the kernels' errors, times
and launch counts, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
BF16_TOL = 2e-2
FP32_TOL = 1e-4


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


def check_kernels(torch):
    """Phase 3: each kernel against its plain version at main-path shapes.
    Returns per-kernel results (max error over all cases, times at the
    decoder shape)."""
    from dynamic_llava_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain)
    from dynamic_llava_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def randn(*shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            dev, dtype)

    res = {"flash_attention_fwd": {"max_abs_err": 0.0},
           "decode_attention_appended": {"max_abs_err": 0.0}}

    def compare(name, got, want, tol, label):
        got, want = got.float(), want.float()
        require(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, atol=tol, rtol=tol)
        log(f"  {label}: max_abs_err={err:.3e} (atol=rtol={tol:g}) "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{label}: kernel disagrees with its plain version")
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)

    # K1: decoder prefill (pre tier 640, post tier 179), CLIP tower, fp32
    k1_cases = [
        ("decoder pre tier", 4, 640, 32, 32, 128, True, [640, 613, 401, 1]),
        ("decoder post tier", 4, 179, 32, 32, 128, True, [179, 175, 90, 1]),
        ("clip tower", 4, 577, 16, 16, 64, False, None),
        ("gqa fp32", 2, 200, 8, 2, 64, True, [200, 0]),
    ]
    for label, b, s, h, hkv, d, causal, lens in k1_cases:
        dtype = torch.float32 if "fp32" in label else torch.bfloat16
        q, k, v = randn(b, s, h, d, dtype=dtype), randn(b, s, hkv, d, dtype=dtype), \
            randn(b, s, hkv, d, dtype=dtype)
        kvl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                     device=dev)
        out, lse = flash_attention(q, k, v, kv_length=kvl, causal=causal,
                                   return_lse=True)
        ref, ref_lse = flash_attention_plain(
            q.float(), k.float(), v.float(), kv_length=kvl, causal=causal,
            return_lse=True)
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        shape = f"B={b} S={s} H={h} Hkv={hkv} d={d} causal={causal} {dtype}"
        compare("flash_attention_fwd", out, ref, tol, f"K1 {label} [{shape}]")
        lse_err = (lse - ref_lse).abs().max().item()
        log(f"  K1 {label}: lse max_abs_err={lse_err:.3e}")
        require(torch.allclose(lse, ref_lse, atol=tol, rtol=tol),
                f"K1 {label}: lse disagrees")
        if label in ("decoder pre tier", "clip tower"):
            kms = time_ms(lambda: flash_attention(q, k, v, kv_length=kvl, causal=causal))
            pms = time_ms(
                lambda: flash_attention_plain(q, k, v, kv_length=kvl, causal=causal))
            log(f"  K1 {label} time: kernel {kms:.4f} ms, plain {pms:.4f} ms")
            if label == "decoder pre tier":
                res["flash_attention_fwd"].update(ms=kms, plain_ms=pms)

    # K2: decode over the pre tier (768) and the sparse post tier (256)
    for max_len, h, hkv, dtype in ((768, 32, 32, torch.bfloat16),
                                   (256, 32, 32, torch.bfloat16),
                                   (256, 8, 2, torch.float32)):
        b, d = 4, 128
        q = randn(b, 1, h, d, dtype=dtype)
        kc, vc = randn(b, max_len, hkv, d, dtype=dtype), randn(b, max_len, hkv, d, dtype=dtype)
        kn, vn = randn(b, 1, hkv, d, dtype=dtype), randn(b, 1, hkv, d, dtype=dtype)
        length = torch.tensor([0, 1, max_len // 2, max_len - 1], dtype=torch.int32,
                              device=dev)
        out = decode_attention(q, kc, vc, kn, vn, length)
        ref = decode_attention_plain(q.float(), kc.float(), vc.float(), kn.float(),
                                     vn.float(), length)
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        label = f"K2 [B={b} max_len={max_len} H={h} Hkv={hkv} d={d} lengths={length.tolist()} {dtype}]"
        compare("decode_attention_appended", out, ref, tol, label)
        if dtype == torch.bfloat16:
            live = torch.full((b,), max_len - 1, dtype=torch.int32, device=dev)
            kms = time_ms(lambda: decode_attention(q, kc, vc, kn, vn, live), 100)
            pms = time_ms(lambda: decode_attention_plain(q, kc, vc, kn, vn, live), 100)
            log(f"  K2 time at max_len={max_len}, every sample at length "
                f"{max_len - 1}: kernel {kms:.4f} ms, plain {pms:.4f} ms")
            if max_len == 768:
                res["decode_attention_appended"].update(ms=kms, plain_ms=pms)
    torch.cuda.synchronize()
    return res


# K5-K8 cases at the 7B decoder's shapes: (label, K, output widths, fp32 out)
QUANT_CASES = [
    ("q/k/v", 4096, (4096, 4096, 4096), False),
    ("gate/up", 4096, (11008, 11008), False),
    ("down", 11008, (4096,), False),
    ("o", 4096, (4096,), False),
    ("lm_head", 4096, (32000,), True),
]
QUANT_ROWS = (1, 8, 24, 64)
QUANT_TOL = {False: 1e-2, True: 1e-4}  # bf16 / fp32 output, relative to max |ref|


def check_quant_kernels(torch):
    """Phase 3, K5-K8: each GEMV against its plain version on the same
    bf16 x and int8 / packed int4 weights (bf16 scales), at every
    QUANT_CASES shape and QUANT_ROWS row count. Times (CUDA events) rotate
    through weight copies of more than 256 MB, so that every call reads its
    weights from HBM as a decode step does. Returns per-kernel results: max
    errors over all cases, times at rows 8."""
    from dynamic_llava_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = {name: {"max_abs_err": 0.0, "max_err_rel": 0.0}
           for name in ("q8_gemv", "q8_gemv_group", "q4_gemv", "q4_gemv_group")}
    for bits in (8, 4):
        for label, k, ns, out_fp32 in QUANT_CASES:
            group = len(ns) > 1
            name = ("q4_gemv" if bits == 4 else "q8_gemv") + ("_group" if group else "")
            kernel, plain = getattr(qm, name), getattr(qm, name + "_plain")
            widths = [n // 2 if bits == 4 else n for n in ns]
            nbytes = k * sum(widths)
            copies = max(2, -(-(256 << 20) // nbytes))
            qmax = 7 if bits == 4 else 127
            weights = [[torch.randint(-128, 128, (k, w), generator=gen, device=dev,
                                      dtype=torch.int8) for w in widths]
                       for _ in range(copies)]
            scales = [torch.rand(1, n, generator=gen, device=dev).mul_(0.02 / qmax)
                      .bfloat16() for n in ns]

            def call(fn, x, ws):
                if group:
                    return fn(x, ws, scales, out_fp32=out_fp32)
                return (fn(x, ws[0], scales[0], out_fp32=out_fp32),)

            for rows in QUANT_ROWS:
                x = torch.randn(rows, k, generator=gen, device=dev).bfloat16()
                got, want = call(kernel, x, weights[0]), call(plain, x, weights[0])
                err = rel = 0.0
                for g, w in zip(got, want):
                    require(bool(torch.isfinite(g).all()), f"{name} {label}: non-finite")
                    e = (g.float() - w.float()).abs().max().item()
                    err, rel = max(err, e), max(rel, e / w.float().abs().max().item())
                tol = QUANT_TOL[out_fp32]
                ok = rel <= tol
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
                res[name]["max_err_rel"] = max(res[name]["max_err_rel"], rel)
                kms = time_ms([lambda ws=ws: call(kernel, x, ws) for ws in weights], 30)
                pms = time_ms([lambda ws=ws: call(plain, x, ws) for ws in weights[:2]], 10)
                deq = [(qm.unpack_int4(w) if bits == 4 else w).bfloat16()
                       for w in weights[0]]
                mms = time_ms(lambda: [x @ w for w in deq], 10)
                del deq
                log(f"  {name} int{bits} {label} [K={k} N={'+'.join(map(str, ns))} "
                    f"rows={rows}{' fp32 out' if out_fp32 else ''}]: max_abs_err="
                    f"{err:.3e}, /max|ref| {rel:.3e} (tol {tol:g}) "
                    f"{'ok' if ok else 'FAIL'}; kernel {kms:.4f} ms "
                    f"({nbytes / kms / 1e6:.0f} GB/s of weights), plain {pms:.4f} ms, "
                    f"bf16 matmul on the dequantized weight (one copy) {mms:.4f} ms")
                require(ok, f"{name} {label} rows={rows}: kernel disagrees with its "
                        "plain version")
                # the JSON line reports the decode step's largest GEMVs at rows 8
                if rows == 8 and label == ("gate/up" if group else "down"):
                    res[name].update(ms=kms, plain_ms=pms, shape=f"{label} rows 8")
            del weights
    torch.cuda.synchronize()
    return res


def check_small_model(torch):
    """Phase 4: greedy generation of a small GQA model (head_dim 64) on the
    card (kernels, fp32) must match the port's plain CPU path token for
    token, with plain, int8 and int4 decoder weights."""
    from dynamic_llava_tpu_torch.config import (
        IMAGE_TOKEN_INDEX, ClipVisionConfig, LlamaConfig, LlavaConfig, SparseConfig)
    from dynamic_llava_tpu_torch.generation.generate import (
        GenerationConfig, Generator)
    from dynamic_llava_tpu_torch.ops.quant import quantize_llm_params
    from dynamic_llava_tpu_torch.weights import init_llava_params

    cfg = LlavaConfig(
        text=LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                              num_attention_heads=4, num_key_value_heads=2),
        vision=ClipVisionConfig.tiny(hidden_size=128, intermediate_size=256,
                                     num_attention_heads=2),
        sparse=SparseConfig(d_model=64, nhead=2, dim_feedforward=128, num_layers=1),
    )
    def to_gpu(t):
        if isinstance(t, dict):
            return {k: to_gpu(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_gpu(v) for v in t]
        return t.cuda()

    rng = np.random.default_rng(SEED)
    ids = [np.concatenate([rng.integers(3, 500, 7), [IMAGE_TOKEN_INDEX],
                           rng.integers(3, 500, 9 + i)]) for i in range(3)]
    pix = rng.standard_normal((3, 56, 56, 3), dtype=np.float32)
    gc = GenerationConfig(max_new_tokens=16, cache_dtype="float32",
                          pad_multiple=8, decode_chunk=8, eos_token_id=-1)
    for bits in (None, 8, 4):
        cpu_params = init_llava_params(cfg, torch.Generator().manual_seed(SEED), "cpu",
                                       torch.float32)
        if bits:
            quantize_llm_params(cpu_params, bits=bits)
        want = Generator(cpu_params, cfg, gc).generate(ids, pix)
        got = Generator(to_gpu(cpu_params), cfg, gc).generate(ids, pix)
        kind = f"int{bits}" if bits else "fp32"
        log(f"  small model ({kind} weights) tokens (card): {got}")
        require(got == want,
                f"small model {kind}: card tokens {got} != plain CPU {want}")
        log(f"  small model ({kind} weights): card == plain CPU path, token for token")


def serve(torch, params, modes, counters, label, b=8, max_new=64, n_text=60):
    """Two batches of ``b`` requests (one image and ``n_text`` text tokens
    each, the same prompts for every call) through ``Generator.generate``
    for each ``(mode, cfg)`` of ``modes`` on the same weights; the second
    is timed. Every kernel in ``counters`` (name -> wrapper) must launch in
    each mode. Returns the per-mode measurements."""
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
    # eos -1: every request runs to max_new, so each run does the same work
    gc = GenerationConfig(max_new_tokens=max_new, temperature=0.0, eos_token_id=-1)
    plan = plan_batch(ids, cfg0.num_image_tokens, pad_multiple=gc.pad_multiple)
    results = {}
    for mode, cfg in modes:
        gen = Generator(params, cfg, gc)
        sizes = gen_cache_sizes(cfg, plan.seq_len, max_new, bucket=gc.pad_multiple)
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outs = []
        for _ in range(2):  # the second batch is timed, past first-call costs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(gen.generate(ids, pix))
            torch.cuda.synchronize()
            e2e = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        rose = {name: fn.launches - before[name] for name, fn in counters.items()}
        require(all(r > 0 for r in rose.values()),
                f"{label} {mode}: kernel launch counters did not rise {rose}")
        out = outs[1]
        require(outs[0] == out, f"{label} {mode}: two batches of the same prompts differ")
        require(len(out) == b and all(len(o) == max_new for o in out),
                f"{label} {mode}: wrong output lengths")
        require(all(0 <= t < vocab for o in out for t in o),
                f"{label} {mode}: token id out of range")
        # TTFT: the same prefill, timed alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            state, info = gen.prefill_from_plan(plan, pix, max_new)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        require(bool(torch.isfinite(state.last_logits).all()),
                f"{label} {mode}: non-finite prefill logits")
        new_len = info.new_length.tolist()
        want_len = [int(v) - (cfg.num_image_tokens - cfg.vision_keep_budget)
                    for v in plan.valid_len]
        require(new_len == want_len,
                f"{label} {mode}: new_length {new_len} != {want_len}")
        require(state.cache.post.max_len == sizes[1], "post tier capacity")
        tok_s = b * max_new / (e2e - ttft)
        results[mode] = dict(e2e_s=e2e, ttft_ms=ttft * 1e3, decode_tok_s=tok_s,
                             peak_gib=peak, pre=sizes[0], post=sizes[1])
        log(f"  {label} {mode}: B={b}, prompt length {plan.seq_len}, tier capacities "
            f"pre={sizes[0]} post={sizes[1]}; generate {e2e:.3f} s, TTFT "
            f"{ttft * 1e3:.1f} ms, decode {tok_s:.1f} tok/s, peak {peak:.2f} GiB, "
            f"new_length {new_len[:2]}... (prompt {plan.valid_len.tolist()[:2]}...), "
            f"launches {rose}, first tokens {out[0][:8]}")
        del state, info
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
    from dynamic_llava_tpu_torch.config import DENSE_SPARSE_CONFIG, LlavaConfig
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
    for line in lib.ptxas_log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log(f"  {line.strip()}")

    log("phase 3: kernels against their plain versions")
    kres = check_kernels(torch)
    kres.update(check_quant_kernels(torch))

    log("phase 4: small model, card against plain CPU path")
    check_small_model(torch)

    counters = {"flash_attention_fwd": flash_attention,
                "decode_attention_appended": decode_attention,
                "q8_gemv": qm.q8_gemv, "q8_gemv_group": qm.q8_gemv_group,
                "q4_gemv": qm.q4_gemv, "q4_gemv_group": qm.q4_gemv_group}
    # the kernels each path must launch; the JSON line reports each
    # kernel's launches in the path named here
    paths = {"bf16": ("flash_attention_fwd", "decode_attention_appended"),
             "int8": ("q8_gemv", "q8_gemv_group"),
             "int4": ("q4_gemv", "q4_gemv_group")}
    launches, results = {}, {}

    def drive(label, params, modes):
        for fn in counters.values():
            fn.launches = 0
        need = {n: counters[n] for n in
                ("flash_attention_fwd", "decode_attention_appended") + paths[label]}
        results[label] = serve(torch, params, modes, need, label)
        launches.update({n: counters[n].launches for n in paths[label]})
        log(f"  {label} path launches: "
            f"{ {n: fn.launches for n, fn in counters.items()} }")

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
    require("jax" not in sys.modules, "jax was imported")
    for label, runs in results.items():
        for mode, r in runs.items():
            log(f"  summary {label} {mode}: TTFT {r['ttft_ms']:.1f} ms, decode "
                f"{r['decode_tok_s']:.1f} tok/s, peak {r['peak_gib']:.2f} GiB")

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
        "q8_gemv": (csrc + "quant_gemv.cu", "dynamic_llava_tpu/ops/quant_matmul.py:226"),
        "q8_gemv_group": (csrc + "quant_gemv.cu",
                          "dynamic_llava_tpu/ops/quant_matmul.py:376"),
        "q4_gemv": (csrc + "quant_gemv.cu", "dynamic_llava_tpu/ops/quant_matmul.py:46"),
        "q4_gemv_group": (csrc + "quant_gemv.cu",
                          "dynamic_llava_tpu/ops/quant_matmul.py:538"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": kres[name]["max_abs_err"],
         "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"]}
        for name, (source, replaces) in table.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
