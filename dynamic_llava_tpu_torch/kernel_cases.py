"""Card-side cases of the decode-attention kernel (K2) and the weight-only
GEMVs (K5-K8): the shapes at which each kernel is held against its plain
PyTorch version on the same inputs, and the functions that do so.

``chip_smoke.py`` (phase 3) and ``tests/test_torch_card_kernels.py`` both run
these lists, so the smoke run and the card-side pytest check the same thing
with the same tolerances. Every case launches its kernel twice and asks for
equal bits (the kernels sum in an order fixed by the shapes). Nothing here
touches CUDA when the module is imported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops import quant_matmul as qm
from .ops.decode_attention import decode_attention, decode_attention_plain, decode_split
from .ops.kv_cache import quantize_kv, to_storage

# atol = rtol against the plain version in fp32 on the same stored values:
# bf16 output rounding; fp32 sums in another order
BF16_TOL = 2e-2
FP32_TOL = 1e-4
# GEMVs: max abs error relative to max |ref|, bf16 / fp32 output
QUANT_TOL = {False: 1e-2, True: 1e-4}


class DecodeCase(NamedTuple):
    label: str
    b: int
    max_len: int
    h: int
    hkv: int
    d: int
    dtype: torch.dtype  # of q, k_cur, v_cur and out
    storage: str  # "own" (q's dtype), "int8" (with bf16 scales) or "fp8"
    lengths: Tuple[int, ...]  # attend bound per sample
    window: Optional[int] = None  # with q_pos = length + 3 (a dense cache)


def _lens(*values):
    return tuple(values)


BF16, FP32 = torch.bfloat16, torch.float32
# a tile of the kernel is 64-256 cache rows (by storage type, head_dim and
# query heads a kv head) and a split owns ceil(max_len / decode_split) rows:
# the lengths sit below, at and above those edges, at 0 and 1, at the capacity
# and past it (the kernel clamps)
_EDGES_768 = _lens(0, 1, 63, 64, 65, 127, 128, 129)
_EDGES_768_HIGH = _lens(191, 192, 193, 255, 256, 257, 768, 800)
_EDGES_256 = _lens(0, 1, 31, 32, 33, 255, 256, 300)
DECODE_CASES = [
    # the main path's shapes (7B: 32 heads, the pre tier 768 and the post tier 256)
    DecodeCase("pre tier", 4, 768, 32, 32, 128, BF16, "own", _lens(0, 1, 384, 767)),
    DecodeCase("post tier", 4, 256, 32, 32, 128, BF16, "own", _lens(0, 1, 128, 255)),
    DecodeCase("pre tier int8", 4, 768, 32, 32, 128, BF16, "int8", _lens(0, 1, 384, 767)),
    DecodeCase("pre tier fp8", 4, 768, 32, 32, 128, BF16, "fp8", _lens(0, 1, 384, 767)),
    DecodeCase("post tier int8", 4, 256, 32, 32, 128, BF16, "int8", _lens(0, 1, 128, 255)),
    DecodeCase("post tier fp8", 4, 256, 32, 32, 128, BF16, "fp8", _lens(0, 1, 128, 255)),
    DecodeCase("13B heads int8", 4, 768, 40, 40, 128, BF16, "int8", _lens(0, 1, 384, 767)),
    DecodeCase("13B heads fp8, one sample", 1, 768, 40, 40, 128, BF16, "fp8", _lens(700)),
    # B = 8 at both tiers, lengths at the tile and split edges
    DecodeCase("B=8 pre tier edges", 8, 768, 32, 32, 128, BF16, "own", _EDGES_768),
    DecodeCase("B=8 pre tier edges, high", 8, 768, 32, 32, 128, BF16, "own", _EDGES_768_HIGH),
    DecodeCase("B=8 pre tier edges int8", 8, 768, 32, 32, 128, BF16, "int8", _EDGES_768_HIGH),
    DecodeCase("B=8 pre tier edges fp8", 8, 768, 32, 32, 128, BF16, "fp8", _EDGES_768),
    DecodeCase("B=8 post tier edges", 8, 256, 32, 32, 128, BF16, "own", _EDGES_256),
    DecodeCase("B=8 post tier edges int8", 8, 256, 32, 32, 128, BF16, "int8", _EDGES_256),
    # few (kv head, sample) pairs: the cache length is split over blocks
    DecodeCase("split, one sample", 1, 1024, 32, 32, 128, BF16, "own", _lens(1000)),
    DecodeCase("split, length 0", 1, 1024, 32, 32, 128, BF16, "int8", _lens(0)),
    DecodeCase("split edges fp32", 8, 768, 8, 2, 128, FP32, "own", _EDGES_768),
    DecodeCase("split edges fp32, high", 8, 768, 8, 2, 128, FP32, "own", _EDGES_768_HIGH),
    # GQA: 4 and 8 query heads a kv head, head_dim 64 and 128
    DecodeCase("gqa 4, d 64, fp32", 4, 256, 8, 2, 64, FP32, "own", _lens(0, 1, 128, 255)),
    DecodeCase("gqa 4, d 64, int8", 8, 256, 8, 2, 64, BF16, "int8", _EDGES_256),
    DecodeCase("gqa 4, d 64, fp8", 8, 256, 8, 2, 64, BF16, "fp8", _EDGES_256),
    DecodeCase("gqa 4, d 64, fp32 q, int8", 4, 256, 8, 2, 64, FP32, "int8", _lens(0, 1, 128, 255)),
    DecodeCase("gqa 4, d 64, fp32 q, fp8", 4, 256, 8, 2, 64, FP32, "fp8", _lens(0, 1, 128, 255)),
    DecodeCase("gqa 8, d 128", 8, 768, 8, 1, 128, BF16, "own", _EDGES_768_HIGH),
    DecodeCase("gqa 8, d 64, int8", 8, 768, 16, 2, 64, BF16, "int8", _EDGES_768),
    DecodeCase("gqa 8, d 64, fp8", 4, 256, 8, 1, 64, BF16, "fp8", _lens(63, 64, 65, 256)),
    DecodeCase("gqa 3, d 64", 3, 200, 12, 4, 64, BF16, "own", _lens(7, 100, 199)),
    DecodeCase("gqa 6, d 128, fp32", 2, 200, 12, 2, 128, FP32, "fp8", _lens(0, 199)),
    # a sliding window: the first visible row is q_pos - window + 1
    DecodeCase("window", 4, 768, 32, 32, 128, BF16, "own", _lens(0, 1, 384, 767), 100),
    DecodeCase("window int8", 4, 768, 32, 32, 128, BF16, "int8", _lens(0, 1, 384, 767), 100),
    DecodeCase("window fp8", 4, 768, 32, 32, 128, BF16, "fp8", _lens(0, 1, 384, 767), 100),
    DecodeCase("window fp32, gqa", 4, 256, 8, 2, 128, FP32, "own", _lens(0, 1, 128, 255), 7),
    # ... and inside a split (12 splits of 64 rows: the window opens at row
    # length + 4 - 150, in mid-split)
    DecodeCase("window inside a split", 4, 768, 8, 2, 64, BF16, "own",
               _lens(200, 300, 400, 767), 150),
    DecodeCase("window inside a split int8", 4, 768, 8, 2, 64, BF16, "int8",
               _lens(200, 300, 400, 767), 150),
]


def make_decode_inputs(case: DecodeCase, device, seed: int = 0):
    """``(args, kwargs)`` of ``decode_attention`` for ``case``, made from a
    numpy seed: q, the stored cache (quantized or cast from normal draws),
    the current K/V, the bounds, and the window / scale keywords."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            device, case.dtype)

    q = randn(case.b, 1, case.h, case.d)
    kf, vf = (randn(case.b, case.max_len, case.hkv, case.d) for _ in range(2))
    kn, vn = (randn(case.b, 1, case.hkv, case.d) for _ in range(2))
    length = torch.tensor(case.lengths, dtype=torch.int32, device=device)
    ks = vs = None
    if case.storage == "int8":
        (kc, ks), (vc, vs) = quantize_kv(kf), quantize_kv(vf)
    elif case.storage == "fp8":
        kc, vc = (to_storage(t, torch.float8_e4m3fn) for t in (kf, vf))
    else:
        kc, vc = kf, vf
    kw = dict(k_scale=ks, v_scale=vs)
    if case.window is not None:
        kw.update(window=case.window, q_pos=length.clamp(max=case.max_len) + 3)
    return (q, kc, vc, kn, vn, length), kw


def check_decode_case(case: DecodeCase, device="cuda") -> float:
    """Runs K2 on ``case`` twice (equal bits) and holds it against the plain
    version in fp32 on the same stored values; returns the max abs error,
    raises ``AssertionError`` on a mismatch."""
    (q, kc, vc, kn, vn, length), kw = make_decode_inputs(case, device)
    out = decode_attention(q, kc, vc, kn, vn, length, **kw)
    again = decode_attention(q, kc, vc, kn, vn, length, **kw)
    ref = decode_attention_plain(q.float(), kc, vc, kn.float(), vn.float(), length, **kw)
    tol = FP32_TOL if case.dtype == torch.float32 else BF16_TOL
    assert out.dtype == case.dtype and out.shape == q.shape, (out.dtype, out.shape)
    assert bool(torch.isfinite(out).all()), f"K2 {case.label}: non-finite output"
    err = (out.float() - ref).abs().max().item()
    assert torch.allclose(out.float(), ref, atol=tol, rtol=tol), (
        f"K2 {case.label}: kernel disagrees with its plain version, max_abs_err {err:.3e} "
        f"(atol=rtol={tol:g})")
    assert torch.equal(out, again), f"K2 {case.label}: two launches differ"
    return err


def describe_decode_case(case: DecodeCase) -> str:
    split = decode_split(case.b, case.hkv, case.max_len)
    return (f"K2 {case.label} [B={case.b} max_len={case.max_len} H={case.h} Hkv={case.hkv} "
            f"d={case.d} q {case.dtype} cache {case.storage} bounds={list(case.lengths)} "
            f"window={case.window} splits={split}]")


class GemvCase(NamedTuple):
    label: str
    k: int
    ns: Tuple[int, ...]  # output columns of the 1-3 weights of one launch
    out_fp32: bool = False


# the 7B decoder's shapes: timed by chip_smoke.py at every QUANT_ROWS row count
QUANT_CASES = [
    GemvCase("q/k/v", 4096, (4096, 4096, 4096)),
    GemvCase("gate/up", 4096, (11008, 11008)),
    GemvCase("down", 11008, (4096,)),
    GemvCase("o", 4096, (4096,)),
    GemvCase("lm_head", 4096, (32000,), True),
]
QUANT_ROWS = (1, 8, 24, 64)
# the edges of the kernel's tiling: a three-weight group of unequal widths (GQA
# q/k/v), widths that end inside a 256-column tile, K that ends inside a k16
# step and inside a unit, one unit, the largest K, the 13B decoder's shapes
QUANT_EDGE_CASES = [
    GemvCase("gqa q/k/v", 4096, (4096, 1024, 1024)),
    GemvCase("one narrow tile", 64, (64,)),
    GemvCase("three narrow tiles, K = 72", 72, (192,)),
    GemvCase("K = 4104", 4104, (320,)),
    GemvCase("unequal group, K = 264", 264, (64, 128, 448)),
    GemvCase("K = 16384", 16384, (256,)),
    GemvCase("one unit, N = 32000", 128, (32000,), True),
    GemvCase("13B down", 13824, (5120,)),
    GemvCase("13B gate/up", 5120, (13824, 13824)),
]
QUANT_EDGE_ROWS = (1, 7, 17, 64)


def gemv_functions(bits: int, group: bool):
    """``(name, kernel wrapper, plain version)`` of K5-K8 by weight bits and
    whether the launch takes a group of weights."""
    name = ("q4_gemv" if bits == 4 else "q8_gemv") + ("_group" if group else "")
    return name, getattr(qm, name), getattr(qm, name + "_plain")


def make_gemv_weights(case: GemvCase, bits: int, device, gen, copies: int = 1):
    """``copies`` sets of random int8 (or packed int4) weights and one set of
    bf16 scales for ``case``."""
    widths = [n // 2 if bits == 4 else n for n in case.ns]
    qmax = 7 if bits == 4 else 127
    weights = [[torch.randint(-128, 128, (case.k, w), generator=gen, device=device,
                              dtype=torch.int8) for w in widths] for _ in range(copies)]
    scales = [torch.rand(1, n, generator=gen, device=device).mul_(0.02 / qmax).bfloat16()
              for n in case.ns]
    return weights, scales


def call_gemv(fn, case: GemvCase, x, ws: Sequence[torch.Tensor], scales):
    """``fn`` (a wrapper or a plain version) on one set of weights; a tuple."""
    if len(case.ns) > 1:
        return tuple(fn(x, ws, scales, out_fp32=case.out_fp32))
    return (fn(x, ws[0], scales[0], out_fp32=case.out_fp32),)


def check_gemv_case(case: GemvCase, bits: int, rows: int, device="cuda", gen=None,
                    weights=None, scales=None) -> Tuple[float, float]:
    """Runs the GEMV of ``case`` twice (equal bits) on bf16 x and holds it
    against its plain version; returns (max abs error, that over max |ref|),
    raises ``AssertionError`` on a mismatch."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    if weights is None:
        (weights,), scales = make_gemv_weights(case, bits, device, gen)
    name, kernel, plain = gemv_functions(bits, len(case.ns) > 1)
    x = torch.randn(rows, case.k, generator=gen, device=device).bfloat16()
    got = call_gemv(kernel, case, x, weights, scales)
    again = call_gemv(kernel, case, x, weights, scales)
    want = call_gemv(plain, case, x, weights, scales)
    err = rel = 0.0
    for g, g2, w in zip(got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, g.shape)
        assert bool(torch.isfinite(g).all()), f"{name} {case.label}: non-finite output"
        assert torch.equal(g, g2), f"{name} {case.label} rows={rows}: two launches differ"
        e = (g.float() - w.float()).abs().max().item()
        err, rel = max(err, e), max(rel, e / w.float().abs().max().item())
    tol = QUANT_TOL[case.out_fp32]
    assert rel <= tol, (f"{name} {case.label} rows={rows}: kernel disagrees with its plain "
                        f"version, max err / max |ref| {rel:.3e} (tol {tol:g})")
    return err, rel
