#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card, ``nvcc`` and
about 20 GB of device memory, and fails (exit code != 0, no result line)
anywhere else. Phases, each of which raises on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``dynamic_llava_tpu_torch/csrc``
   with ``nvcc`` for ``sm_90a`` and print the build time and ``ptxas``
   resource lines;
3. hold each kernel against its plain PyTorch version at the shapes of the
   main path (bf16 inputs against the plain version in fp32 on the same
   values, atol = rtol = 2e-2 for bf16 output rounding; fp32 inputs at
   atol = rtol = 1e-4), timing both with CUDA events;
4. a small model (head_dim 64, GQA) generated greedily on the card through
   the kernels must give the same tokens as the port's plain CPU path,
   which the CPU tests hold token-exact against the JAX package;
5. the main path at LLaVA-1.5-7B width (32 layers, random bf16 weights made
   on the card from a seed): two batches of 4 requests (one 336x336 image
   and 60 text tokens each, 64 new tokens, greedy) through
   ``Generator.generate``, sparse and then dense, with the kernels' launch
   counters read around it.

The last two lines of standard output are a JSON object with the kernels'
errors, times and launch counts, and ``{"ok": true, "device": {...}}``.
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
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after two warm-up calls)."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def check_small_model(torch):
    """Phase 4: greedy generation of a small GQA model (head_dim 64) on the
    card (kernels, fp32) must match the port's plain CPU path token for
    token."""
    from dynamic_llava_tpu_torch.config import (
        IMAGE_TOKEN_INDEX, ClipVisionConfig, LlamaConfig, LlavaConfig, SparseConfig)
    from dynamic_llava_tpu_torch.generation.generate import (
        GenerationConfig, Generator)
    from dynamic_llava_tpu_torch.weights import init_llava_params

    cfg = LlavaConfig(
        text=LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                              num_attention_heads=4, num_key_value_heads=2),
        vision=ClipVisionConfig.tiny(hidden_size=128, intermediate_size=256,
                                     num_attention_heads=2),
        sparse=SparseConfig(d_model=64, nhead=2, dim_feedforward=128, num_layers=1),
    )
    gen = torch.Generator().manual_seed(SEED)
    cpu_params = init_llava_params(cfg, gen, "cpu", torch.float32)
    def to_gpu(t):
        if isinstance(t, dict):
            return {k: to_gpu(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_gpu(v) for v in t]
        return t.cuda()

    gpu_params = to_gpu(cpu_params)
    rng = np.random.default_rng(SEED)
    ids = [np.concatenate([rng.integers(3, 500, 7), [IMAGE_TOKEN_INDEX],
                           rng.integers(3, 500, 9 + i)]) for i in range(3)]
    pix = rng.standard_normal((3, 56, 56, 3), dtype=np.float32)
    gc = GenerationConfig(max_new_tokens=16, cache_dtype="float32",
                          pad_multiple=8, decode_chunk=8, eos_token_id=-1)
    want = Generator(cpu_params, cfg, gc).generate(ids, pix)
    got = Generator(gpu_params, cfg, gc).generate(ids, pix)
    log(f"  small model tokens (card): {got}")
    require(got == want, f"small model: card tokens {got} != plain CPU {want}")
    log("  small model: card == plain CPU path, token for token")


def serve(torch, params, cfg_sparse, cfg_dense, b=4, max_new=64, n_text=60):
    """Phase 5: two batches of ``b`` requests (one image and
    ``n_text`` text tokens each) through ``Generator.generate``, sparse then
    dense, on the same weights. Returns the per-batch measurements."""
    from dynamic_llava_tpu_torch.config import IMAGE_TOKEN_INDEX
    from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
    from dynamic_llava_tpu_torch.models.dynamic import gen_cache_sizes
    from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
    from dynamic_llava_tpu_torch.ops.decode_attention import decode_attention
    from dynamic_llava_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(SEED)
    vocab, size = cfg_sparse.text.vocab_size, cfg_sparse.vision.image_size

    def batch():
        ids = [np.concatenate([rng.integers(3, vocab, n_text // 2), [IMAGE_TOKEN_INDEX],
                               rng.integers(3, vocab, n_text - n_text // 2)])
               for _ in range(b)]
        pix = rng.standard_normal((b, size, size, 3), dtype=np.float32)
        return ids, pix

    batches = [batch() for _ in range(2)]
    # eos -1: every request runs to max_new, so each run does the same work
    gc = GenerationConfig(max_new_tokens=max_new, temperature=0.0, eos_token_id=-1)
    prompt_len = plan_batch(batches[0][0], cfg_sparse.num_image_tokens,
                            pad_multiple=gc.pad_multiple).seq_len
    results = {}
    counters = (flash_attention, decode_attention)
    for mode, cfg in (("sparse", cfg_sparse), ("dense", cfg_dense)):
        gen = Generator(params, cfg, gc)
        sizes = gen_cache_sizes(cfg, prompt_len, max_new, bucket=gc.pad_multiple)
        log(f"  {mode}: prompt length {prompt_len}, tier capacities "
            f"pre={sizes[0]} post={sizes[1]}")
        runs = []
        for bi, (ids, pix) in enumerate(batches):
            before = [fn.launches for fn in counters]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = gen.generate(ids, pix)
            torch.cuda.synchronize()
            e2e = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            rose = [fn.launches - n for fn, n in zip(counters, before)]
            require(all(r > 0 for r in rose),
                    f"{mode} batch {bi}: kernel launch counters did not rise {rose}")
            require(len(out) == b and all(len(o) == max_new for o in out),
                    f"{mode} batch {bi}: wrong output lengths")
            require(all(0 <= t < vocab for o in out for t in o),
                    f"{mode} batch {bi}: token id out of range")
            # TTFT: the same prefill, timed alone
            plan = plan_batch(ids, cfg.num_image_tokens, pad_multiple=gc.pad_multiple)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                state, info = gen.prefill_from_plan(plan, pix, max_new)
            torch.cuda.synchronize()
            ttft = time.perf_counter() - t0
            require(bool(torch.isfinite(state.last_logits).all()),
                    f"{mode}: non-finite prefill logits")
            new_len = info.new_length.tolist()
            want_len = [int(v) - (cfg.num_image_tokens - cfg.vision_keep_budget)
                        for v in plan.valid_len]
            require(new_len == want_len, f"{mode}: new_length {new_len} != {want_len}")
            require(state.cache.post.max_len == sizes[1], "post tier capacity")
            tok_s = b * max_new / (e2e - ttft)
            runs.append(dict(e2e_s=e2e, ttft_ms=ttft * 1e3, decode_tok_s=tok_s,
                             peak_gib=peak, pre=sizes[0], post=sizes[1]))
            log(f"  {mode} batch {bi}: generate {e2e:.3f} s, TTFT {ttft * 1e3:.1f} ms, "
                f"decode {tok_s:.1f} tok/s, peak {peak:.2f} GiB, "
                f"new_length {new_len} (prompt {plan.valid_len.tolist()}), "
                f"launches K1 +{rose[0]} K2 +{rose[1]}, first tokens {out[0][:8]}")
        results[mode] = runs
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
    from dynamic_llava_tpu_torch.ops.flash_attention import flash_attention
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

    log("phase 4: small model, card against plain CPU path")
    check_small_model(torch)

    log("phase 5: LLaVA-1.5-7B width, random bf16 weights, sparse and dense")
    cfg_sparse = LlavaConfig()
    cfg_dense = LlavaConfig(sparse=DENSE_SPARSE_CONFIG)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = init_llava_params(
        cfg_sparse, torch.Generator(device=dev).manual_seed(SEED), dev, torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  params: {param_bytes(params) / 2**30:.2f} GiB in "
        f"{time.perf_counter() - t0:.1f} s")

    # the main path: every launch counter starts at 0 here
    for fn in (flash_attention, decode_attention):
        fn.launches = 0
    results = serve(torch, params, cfg_sparse, cfg_dense)
    launches = {"flash_attention_fwd": flash_attention.launches,
                "decode_attention_appended": decode_attention.launches}
    require("jax" not in sys.modules, "jax was imported")
    sp, de = results["sparse"][-1], results["dense"][-1]
    log(f"  steady batch: sparse TTFT {sp['ttft_ms']:.1f} ms / dense "
        f"{de['ttft_ms']:.1f} ms; sparse decode {sp['decode_tok_s']:.1f} tok/s / "
        f"dense {de['decode_tok_s']:.1f} tok/s")

    source = {"flash_attention_fwd": "dynamic_llava_tpu_torch/csrc/flash_attention_fwd.cu",
              "decode_attention_appended": "dynamic_llava_tpu_torch/csrc/decode_attention.cu"}
    replaces = {"flash_attention_fwd": "dynamic_llava_tpu/ops/flash_attention.py:38",
                "decode_attention_appended": "dynamic_llava_tpu/ops/decode_attention.py:29"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source[name],
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"]}
        for name in ("flash_attention_fwd", "decode_attention_appended")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
