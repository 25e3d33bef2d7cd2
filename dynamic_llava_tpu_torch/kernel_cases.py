"""Card-side cases of the flash forward (K1) and backward (K3, with its delta
kernel), the policy attention (K4), the decode-attention kernel (K2) and its
M-query form (K2-M), the weight-only GEMVs (K5-K8) and the fused int4 MLP
(K9): the shapes at which
each kernel is held against its plain PyTorch version on the same inputs,
and the functions that do so.

``chip_smoke.py`` (phase 3) and ``tests/test_torch_card_kernels.py`` both run
these lists, so the smoke run and the card-side pytest check the same thing
with the same tolerances. Every case launches its kernel twice and asks for
equal bits (the kernels sum in an order fixed by the shapes). Nothing here
touches CUDA when the module is imported.

``device_launches`` counts the serving path's kernels by the names the card
reports, in a ``torch.profiler`` trace: the launches of a CUDA graph's
replays, which no wrapper sees (``chip_smoke.py`` phases 5-8 and
``tests/test_torch_card_graph.py``).
"""

from __future__ import annotations

import re
import time
from collections import Counter
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops import flash_attention as fa
from .ops import quant_matmul as qm
from .ops.decode_attention import (
    decode_attention, decode_attention_plain, decode_split, extend_attention,
    extend_attention_plain, extend_mask, extend_plan)
from .ops.flash_policy import flash_policy_attention, flash_policy_attention_plain
from .ops.kv_cache import quantize_kv, to_storage

# atol = rtol against the plain version in fp32 on the same stored values:
# bf16 output rounding; fp32 sums in another order
BF16_TOL = 2e-2
FP32_TOL = 1e-4
# GEMVs: max abs error relative to max |ref|, bf16 / fp32 output
QUANT_TOL = {False: 1e-2, True: 1e-4}


class FlashCase(NamedTuple):
    label: str
    b: int
    sq: int
    sk: int
    h: int
    hkv: int
    d: int
    causal: bool
    lengths: Optional[Tuple[int, ...]]  # kv_length per sample; None: every column
    dtype: torch.dtype  # of q, k, v, dout and out
    q_offset: int = 0  # K1 only


BF16, FP32 = torch.bfloat16, torch.float32
# K1: the decoder's prefill (pre tier 640, post tier 179; chip_smoke.py times
# the pre tier) and the CLIP tower (timed too), and the edges of the 64-row
# tiles: one tile and one row more, a kv_length of 0 and one in mid-tile, GQA
# with 4 query heads a kv head, a q_offset with Sq < Sk, bf16 and fp32
FLASH_FWD_CASES = [
    FlashCase("decoder pre tier", 4, 640, 640, 32, 32, 128, True, (640, 613, 401, 1), BF16),
    FlashCase("decoder post tier", 4, 179, 179, 32, 32, 128, True, (179, 175, 90, 1), BF16),
    FlashCase("clip tower", 4, 577, 577, 16, 16, 64, False, None, BF16),
    FlashCase("gqa", 2, 200, 200, 8, 2, 64, True, (200, 0), FP32),
    FlashCase("one tile", 2, 64, 64, 4, 4, 128, True, None, BF16),
    FlashCase("one tile and a row", 2, 65, 65, 4, 2, 64, True, None, BF16),
    FlashCase("one tile and a row", 2, 65, 65, 4, 2, 128, True, (65, 30), FP32),
    FlashCase("gqa kv_length 0 and mid-tile", 3, 200, 200, 8, 2, 64, True, (0, 77, 200), BF16),
    FlashCase("q_offset, Sq < Sk", 2, 70, 150, 8, 4, 128, True, (150, 97), BF16, 80),
    FlashCase("q_offset, Sq < Sk", 2, 70, 150, 4, 2, 64, True, (150, 97), FP32, 80),
    FlashCase("non-causal Sq < Sk kv_length", 2, 70, 150, 4, 4, 64, False, (33, 150), BF16),
    # head_dim 16 and 32, zero-padded to 64 by the wrapper (the quality gates)
    FlashCase("d 16, padded", 32, 35, 35, 4, 4, 16, True, (35, 20) * 16, FP32),
    FlashCase("d 16 non-causal, padded", 8, 26, 26, 2, 2, 16, False, None, FP32),
    FlashCase("d 32 gqa, padded", 2, 70, 70, 4, 2, 32, True, (70, 33), BF16),
    # the shapes of the high-resolution and family phases (chip_smoke.py times
    # them): an anyres prefill of ~2.9k tokens, Mistral's GQA 32 / 8 at the
    # window's length, the CLIP tower over S2's 1 + 4 + 9 tiles
    FlashCase("anyres prefill", 1, 2944, 2944, 32, 32, 128, True, None, BF16),
    FlashCase("mistral gqa", 1, 4096, 4096, 32, 8, 128, True, None, BF16),
    FlashCase("clip s2", 14, 577, 577, 16, 16, 64, False, None, BF16),
]
# K1 cases that chip_smoke.py times beside the decoder's and the tower's
TIMED_FLASH_SHAPES = ("anyres prefill", "mistral gqa", "clip s2")
# K3: the training shape (chip_smoke.py times the bf16 one) and the edges of
# the 64-row tiles: GQA with 4 query heads a kv head at d 64, a kv_length of
# 0 and one in mid-tile, one tile and one row more, Sq != Sk without a causal
# mask, bf16 and fp32
TRAIN_SHAPE = FlashCase("training shape", 4, 1663, 1663, 32, 32, 128, True, None, BF16)
FLASH_BWD_CASES = [
    TRAIN_SHAPE,
    TRAIN_SHAPE._replace(dtype=FP32),
    FlashCase("gqa kv_length", 2, 200, 200, 8, 2, 64, True, (200, 77), FP32),
    FlashCase("gqa non-causal kv_length", 2, 150, 150, 4, 2, 128, False, (0, 150), BF16),
    FlashCase("gqa n_rep 4", 2, 130, 130, 8, 2, 64, True, None, BF16),
    FlashCase("gqa kv_length 0 and mid-tile", 3, 200, 200, 8, 2, 64, True, (0, 77, 200), BF16),
    FlashCase("one tile", 2, 64, 64, 4, 4, 128, True, None, BF16),
    FlashCase("one tile and a row", 2, 65, 65, 4, 2, 128, True, (65, 64), BF16),
    FlashCase("non-causal Sq != Sk", 2, 70, 150, 4, 2, 64, False, (150, 97), BF16),
    FlashCase("non-causal Sq != Sk", 2, 150, 70, 4, 2, 64, False, None, FP32),
    FlashCase("d 16, padded", 32, 35, 35, 4, 4, 16, True, (35, 20) * 16, FP32),
    FlashCase("d 32 gqa, padded", 2, 70, 70, 4, 2, 32, True, (70, 33), BF16),
]


def make_flash_inputs(case: FlashCase, device, seed: int = 0):
    """``(q, k, v, dout, kv_length)`` for ``case``, made from a numpy seed."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            device, case.dtype)

    q = randn(case.b, case.sq, case.h, case.d)
    k, v = (randn(case.b, case.sk, case.hkv, case.d) for _ in range(2))
    g = randn(case.b, case.sq, case.h, case.d)
    kvl = (None if case.lengths is None
           else torch.tensor(case.lengths, dtype=torch.int32, device=device))
    return q, k, v, g, kvl


def _close(name: str, got, want, tol: float) -> float:
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all()), f"{name}: non-finite output"
    err = (got - want).abs().max().item()
    assert torch.allclose(got, want, atol=tol, rtol=tol), (
        f"{name}: kernel disagrees with its plain version, max_abs_err {err:.3e} "
        f"(atol=rtol={tol:g})")
    return err


def check_flash_fwd_case(case: FlashCase, device="cuda") -> Tuple[float, float]:
    """Runs K1 on ``case`` twice (equal bits) and holds output and lse
    against the plain version in fp32 on the same values; returns (max abs
    error of the output, of the lse), raises ``AssertionError`` on a
    mismatch."""
    q, k, v, _, kvl = make_flash_inputs(case, device)
    kw = dict(kv_length=kvl, causal=case.causal, q_offset=case.q_offset)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    again, lse2 = fa.flash_attention(q, k, v, return_lse=True, **kw)
    ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), return_lse=True,
                                            **kw)
    tol = FP32_TOL if case.dtype == torch.float32 else BF16_TOL
    assert out.dtype == case.dtype and out.shape == q.shape, (out.dtype, out.shape)
    err = _close(f"K1 {case.label}", out, ref, tol)
    lse_err = _close(f"K1 {case.label} lse", lse, ref_lse, tol)
    # the same bits every launch (a layer re-run under checkpointing)
    assert torch.equal(out, again) and torch.equal(lse, lse2), \
        f"K1 {case.label}: two launches differ"
    return err, lse_err


def check_flash_bwd_case(case: FlashCase, device="cuda") -> dict:
    """Runs K3 (delta, dq and dkv: one launch each) on ``case`` twice (equal
    bits) and holds dq, dk and dv against the plain backward in fp32 from its
    own forward, and the delta kernel against ``_delta`` on the same out and
    dout (fp32 sums of d products in another order: 1e-4); returns the max
    abs errors by ``dq`` / ``dk`` / ``dv`` / ``delta``, raises
    ``AssertionError`` on a mismatch."""
    q, k, v, g, kvl = make_flash_inputs(case, device, seed=1)
    kw = dict(kv_length=kvl, causal=case.causal)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    wrappers = (fa.flash_attention_bwd_delta, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    before = [w.launches for w in wrappers]
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    assert [w.launches for w in wrappers] == [n + 1 for n in before], "K3 launch counters"
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape] and \
        {t.dtype for t in got} == {case.dtype}, \
        f"K3 {case.label}: dq / dk / dv must have q / k / v's shape and type"
    # the same bits every launch (a layer re-run under checkpointing)
    again = fa.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        f"K3 {case.label}: two launches differ"
    del again
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    rout, rlse = fa.flash_attention_plain(qf, kf, vf, return_lse=True, **kw)
    want = fa.flash_attention_bwd_plain(qf, kf, vf, rout, rlse, gf, **kw)
    tol = FP32_TOL if case.dtype == torch.float32 else BF16_TOL
    errs = {name: _close(f"K3 {name} {case.label}", a, b, tol)
            for name, a, b in zip(("dq", "dk", "dv"), got, want)}
    delta = fa.flash_attention_bwd_delta(out, g)
    assert delta.shape == (case.b, case.h, case.sq), delta.shape
    errs["delta"] = _close(f"K3 delta {case.label}", delta, fa._delta(out, g), FP32_TOL)
    return errs


def describe_flash_case(case: FlashCase) -> str:
    return (f"[B={case.b} Sq={case.sq} Sk={case.sk} H={case.h} Hkv={case.hkv} d={case.d} "
            f"causal={case.causal} lens={None if case.lengths is None else list(case.lengths)} "
            f"q_offset={case.q_offset} {case.dtype}]")


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
    # Mistral-7B (GQA 32 / 8) past its 4096-token window: the cache holds
    # more than the window (chip_smoke.py times it)
    DecodeCase("mistral window", 1, 4736, 32, 8, 128, BF16, "own", _lens(4700), 4096),
    # head_dim 16 and 32, zero-padded to 64 by the wrapper (the quality gates)
    DecodeCase("d 16, padded", 4, 40, 4, 4, 16, FP32, "own", _lens(0, 1, 20, 39)),
    DecodeCase("d 16 int8, padded", 4, 40, 4, 4, 16, BF16, "int8", _lens(0, 1, 20, 39)),
    DecodeCase("d 32 gqa fp8, padded", 4, 64, 4, 2, 32, BF16, "fp8", _lens(0, 1, 33, 63)),
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


class ExtendCase(NamedTuple):
    label: str
    b: int
    m: int  # chunk tokens a sample
    max_len: int
    h: int
    hkv: int
    d: int
    dtype: torch.dtype  # of q, the chunk's K/V and out
    storage: str  # "own" (q's dtype), "int8" (with bf16 scales) or "fp8"
    lengths: Tuple[int, ...]  # persisted bound per sample
    attend: bool = False  # a random chunk_attend mask
    window: Optional[int] = None  # with positions = length + arange(M)
    attend_rate: float = 0.5  # with ``attend``: the share of chunk columns attended


# K2-M: a bf16 q over a bf16, int8 or fp8 cache runs on the tensor cores in
# tiles of 64 query rows (chunk token x head of a kv head), an fp32 q or
# cache on the CUDA cores in groups of 8, so M x n_rep at 1, 2, 7, 8, 9, 40,
# 65 and 128 crosses the group edges (and the tiles' below); the cache
# lengths sit at 0, at the tile and split edges and at the capacity, ragged
# across B = 4; every storage type, 1 and 4 query heads a kv head, head_dim
# 64 and 128, a chunk_attend mask and a window. The chat shapes come first:
# 7B (32 heads, d 128), the pre tier of chip_smoke.py's chat phase (1088
# slots), rounds 2 and 3 (40 tokens at length 700, 100 at 804).
_STORES = ("own", "int8", "fp8")
EXTEND_CASES = [
    ExtendCase("chat chunk 40", 1, 40, 1088, 32, 32, 128, BF16, "own", (700,)),
    ExtendCase("chat chunk 100", 1, 100, 1088, 32, 32, 128, BF16, "own", (804,)),
    ExtendCase("chat chunk 40 int8", 1, 40, 1088, 32, 32, 128, BF16, "int8", (700,)),
    ExtendCase("chat chunk 100 int8", 1, 100, 1088, 32, 32, 128, BF16, "int8", (804,)),
] + [
    ExtendCase(f"M={m} gqa 4 d 64 {store}", 4, m, 256, 8, 2, 64, BF16, store,
               (0, 63, 129, 256))
    for i, m in enumerate((1, 2, 7, 8, 9, 40, 65, 128)) for store in (_STORES[i % 3],)
] + [
    ExtendCase(f"M={m} d 128 {store}", 4, m, 768, 4, 4, 128, BF16, store, (1, 64, 255, 767))
    for m, store in ((1, "fp8"), (2, "int8"), (8, "own"), (9, "fp8"), (65, "int8"))
] + [
    # few (kv head, sample, row group) blocks: the cache length is split
    ExtendCase("split, one sample", 1, 7, 1024, 2, 2, 128, BF16, "own", (1000,)),
    ExtendCase("split, length 0", 1, 3, 1024, 8, 2, 64, BF16, "int8", (0,)),
    ExtendCase("split edges fp32", 4, 2, 768, 8, 2, 128, FP32, "own", (64, 65, 129, 800)),
    ExtendCase("split fp32 q, fp8", 2, 9, 512, 4, 4, 64, FP32, "fp8", (511, 200)),
    ExtendCase("fp32", 4, 40, 256, 8, 2, 128, FP32, "own", (0, 1, 128, 255)),
    ExtendCase("fp32 q, int8", 4, 9, 256, 4, 1, 64, FP32, "int8", (32, 33, 256, 7)),
    # chunk_attend, a window, both
    ExtendCase("chunk_attend", 4, 40, 256, 8, 2, 64, BF16, "own", (0, 63, 129, 256), True),
    ExtendCase("chunk_attend int8", 4, 65, 768, 4, 4, 128, BF16, "int8", (1, 64, 255, 767),
               True),
    ExtendCase("window", 4, 40, 768, 4, 4, 128, BF16, "own", (0, 100, 300, 767), False, 64),
    ExtendCase("window fp8", 4, 9, 256, 8, 2, 64, BF16, "fp8", (0, 63, 129, 256), False, 5),
    ExtendCase("chunk_attend and window, fp32", 2, 128, 768, 8, 2, 64, FP32, "int8",
               (500, 767), True, 100),
    ExtendCase("window inside a split", 1, 7, 1024, 2, 2, 64, BF16, "own", (900,), True, 150),
]
# the tensor-core form's tiles, bf16 q on every storage type: M x n_rep at
# 16, 17, 63, 64, 65, 128 and 129 with one query head a kv head (a split of
# 67 rows, so tiles straddle the split edges), and with four the multiples
# of 4 at and beside the 16- and 64-row edges (16, 20, 60, 64, 68, 128,
# 132); eight query heads a kv head (16 and 72 rows); a 64-row tile whose
# tokens' windows start on both sides of a cache tile edge (positions
# 300-363, window 100: first rows 201-264); chunk_attend all false (every
# row sees the cache and its own column)
EXTEND_CASES += [
    ExtendCase(f"tile edge M={m} {store}", 3, m, 333, 2, 2, 128, BF16, store, (0, 65, 333))
    for m in (16, 17, 63, 64, 65, 128, 129) for store in _STORES
] + [
    ExtendCase(f"tile edge gqa 4 M={m} {store}", 3, m, 320, 8, 2, 64, BF16, store,
               (1, 128, 320), True)
    for m in (4, 5, 15, 16, 17, 32, 33) for store in _STORES
] + [
    ExtendCase(f"gqa 8 M={m} {store}", 2, m, 256, 16, 2, 128, BF16, store, (5, 200))
    for m in (2, 9) for store in _STORES
] + [
    ExtendCase(f"tile across a window start {store}", 2, 64, 400, 2, 2, 128, BF16, store,
               (300, 190), False, 100)
    for store in _STORES
] + [
    ExtendCase(f"chunk_attend all false {store}", 3, 40, 256, 8, 2, 64, BF16, store,
               (0, 100, 256), True, None, 0.0)
    for store in _STORES
]
# the verify rounds of speculative decoding (chip_smoke.py phase 5c): 7B
# width (32 heads, d 128), the post tier of a sparse 640-slot prompt (320
# slots, 150-300 persisted), B = 1 and 8, M = k + 1 = 5 and 8, bf16 and int8
# caches, the output-text predictor's keep as chunk_attend
_VERIFY_LENGTHS = {1: (180,), 8: (150, 172, 195, 210, 233, 251, 276, 300)}
VERIFY_CASES = [
    ExtendCase(f"verify B={b} M={m} {store}", b, m, 320, 32, 32, 128, BF16, store,
               _VERIFY_LENGTHS[b], True)
    for b in (1, 8) for m in (5, 8) for store in ("own", "int8")
]
EXTEND_CASES += VERIFY_CASES


def make_extend_inputs(case: ExtendCase, device, seed: int = 0):
    """``(args, kwargs)`` of ``extend_attention`` for ``case``, made from a
    numpy seed: q, the stored cache, the chunk's K/V, the bounds, and the
    chunk_attend / window keywords."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            device, case.dtype)

    q = randn(case.b, case.m, case.h, case.d)
    kf, vf = (randn(case.b, case.max_len, case.hkv, case.d) for _ in range(2))
    kn, vn = (randn(case.b, case.m, case.hkv, case.d) for _ in range(2))
    length = torch.tensor(case.lengths, dtype=torch.int32, device=device)
    ks = vs = None
    if case.storage == "int8":
        (kc, ks), (vc, vs) = quantize_kv(kf), quantize_kv(vf)
    elif case.storage == "fp8":
        kc, vc = (to_storage(t, torch.float8_e4m3fn) for t in (kf, vf))
    else:
        kc, vc = kf, vf
    kw = dict(k_scale=ks, v_scale=vs)
    if case.attend:
        kw["chunk_attend"] = torch.from_numpy(
            rng.random((case.b, case.m)) < case.attend_rate).to(device)
    if case.window is not None:
        start = length.clamp(max=case.max_len)[:, None]
        kw.update(window=case.window, positions=(start + torch.arange(
            case.m, dtype=torch.int32, device=device)[None]).to(torch.int32).contiguous())
    return (q, kc, vc, kn, vn, length), kw


def extend_plain(q, kc, vc, kn, vn, length, chunk_attend=None, window=None, positions=None,
                 k_scale=None, v_scale=None):
    """The plain version in fp32 on the same stored values, under the mask
    the structured arguments give."""
    mask = extend_mask(length, kc.shape[1], q.shape[1], chunk_attend=chunk_attend,
                       window=window, positions=positions)
    return extend_attention_plain(q.float(), kc, vc, kn.float(), vn.float(), mask,
                                  k_scale=k_scale, v_scale=v_scale)


def check_extend_case(case: ExtendCase, device="cuda") -> float:
    """Runs the M-query kernel on ``case`` twice (equal bits) and holds it
    against the plain version in fp32 on the same stored values; returns
    the max abs error, raises ``AssertionError`` on a mismatch."""
    args, kw = make_extend_inputs(case, device)
    before = extend_attention.launches
    out = extend_attention(*args, **kw)
    again = extend_attention(*args, **kw)
    assert extend_attention.launches == before + 2, "K2-M launch counter"
    ref = extend_plain(*args, **kw)
    tol = FP32_TOL if case.dtype == torch.float32 else BF16_TOL
    assert out.dtype == case.dtype and out.shape == args[0].shape, (out.dtype, out.shape)
    err = _close(f"K2-M {case.label}", out, ref, tol)
    assert torch.equal(out, again), f"K2-M {case.label}: two launches differ"
    return err


def extend_case_plan(case: ExtendCase):
    """``extend_plan`` of ``case``."""
    store = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(case.storage, case.dtype)
    return extend_plan(case.b, case.m, case.h, case.hkv, case.d, case.max_len, case.dtype,
                       store)


def check_extend_dispatch(cases: Sequence[ExtendCase], device="cuda") -> Dict[str, int]:
    """Launches the M-query wrapper once a case, all in one profiler trace,
    and holds the kernels the card ran to ``extend_plan``:
    ``extend_mma_kernel`` once for each tensor-core case, ``extend_kernel``
    once for each other case, no other launch of either. Returns the
    counts by kernel; raises ``AssertionError`` on a mismatch."""
    inputs = [make_extend_inputs(case, device) for case in cases]
    _, names = kernel_launches(lambda: [extend_attention(*a, **kw) for a, kw in inputs])
    got = {k: sum(n for name, n in names.items() if re.search(k + "[<I]", name))
           for k in ("extend_mma_kernel", "extend_kernel")}
    mma = sum(extend_case_plan(case).tensor_cores for case in cases)
    want = {"extend_mma_kernel": mma, "extend_kernel": len(cases) - mma}
    assert got == want, f"K2-M kernels launched {got}, extend_plan says {want}"
    return got


def describe_extend_case(case: ExtendCase) -> str:
    plan = extend_case_plan(case)
    attend = f"{case.attend}" + (f" (rate {case.attend_rate})" if case.attend else "")
    return (f"K2-M {case.label} [B={case.b} M={case.m} max_len={case.max_len} H={case.h} "
            f"Hkv={case.hkv} d={case.d} q {case.dtype} cache {case.storage} "
            f"bounds={list(case.lengths)} chunk_attend={attend} window={case.window} "
            f"{'tensor cores' if plan.tensor_cores else 'CUDA cores'}, "
            f"row tiles={plan.row_tiles} splits={plan.n_split}]")


class GemvCase(NamedTuple):
    label: str
    k: int
    ns: Tuple[int, ...]  # output columns of the 1-3 weights of one launch
    out_fp32: bool = False
    x_fp32: bool = False  # fp32 x (the CUDA-core kernel) instead of bf16


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
# step and inside a unit, one unit, the largest K, the 13B decoder's shapes;
# widths that are not a multiple of 64 (rows of whole 16-byte pieces or not:
# a small vocabulary's lm_head, a ragged group, a sliced ragged tile), and
# the same on fp32 x
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
    GemvCase("N = 24", 256, (24,), True),
    GemvCase("N = 80, K = 72", 72, (80,)),
    GemvCase("ragged group, K = 264", 264, (40, 24, 88)),
    GemvCase("N = 1000, sliced", 4096, (1000,)),
    GemvCase("fp32 x, N = 24", 256, (24,), x_fp32=True),
    GemvCase("fp32 x, ragged group", 264, (40, 24, 88), x_fp32=True),
    GemvCase("fp32 x, gqa q/k/v", 4096, (4096, 1024, 1024), x_fp32=True),
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
    """Runs the GEMV of ``case`` twice (equal bits) on bf16 x (fp32 with
    ``case.x_fp32``) and holds it against its plain version; returns (max
    abs error, that over max |ref|), raises ``AssertionError`` on a
    mismatch."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    if weights is None:
        (weights,), scales = make_gemv_weights(case, bits, device, gen)
    name, kernel, plain = gemv_functions(bits, len(case.ns) > 1)
    x = torch.randn(rows, case.k, generator=gen, device=device)
    x = x if case.x_fp32 else x.bfloat16()
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
    tol = QUANT_TOL[case.out_fp32 or case.x_fp32]
    assert rel <= tol, (f"{name} {case.label} rows={rows}: kernel disagrees with its plain "
                        f"version, max err / max |ref| {rel:.3e} (tol {tol:g})")
    return err, rel


class PolicyCase(NamedTuple):
    label: str
    b: int
    s: int
    h: int
    hkv: int
    d: int
    dtype: torch.dtype  # of q, k, v and out
    policy: str  # "zeros", "ones", "soft" (uniform in [0, 1)) or "mixed" (below)


# the training shape (30 policy layers of a sparse step; chip_smoke.py times
# the bf16 one), a policy that is 0 on half the columns, 1 on 30% and soft on
# the rest
POLICY_CASES = [
    PolicyCase("training shape", 4, 1663, 32, 32, 128, BF16, "mixed"),
    PolicyCase("training shape", 4, 1663, 32, 32, 128, FP32, "mixed"),
    PolicyCase("gqa", 2, 203, 8, 2, 64, FP32, "mixed"),
    PolicyCase("d 16, padded", 32, 35, 4, 4, 16, FP32, "mixed"),
    PolicyCase("d 32 gqa, padded", 2, 70, 4, 2, 32, BF16, "mixed"),
]
# the edges of the 64-row q and kv tiles (one row, a row short of a tile, one
# tile, a row past it, two tiles and a row), 4 query heads a kv head, head_dim
# 64 and 128, and a policy that drops every column but the diagonal, keeps
# every column, or is soft
POLICY_EDGE_CASES = [
    PolicyCase(f"S={s} d={d} policy {pol}", 2, s, 8, 2, d, dtype, pol)
    for s in (1, 63, 64, 65, 129) for d in (64, 128) for pol in ("zeros", "ones", "soft")
    for dtype in (BF16, FP32)
]


def make_policy_inputs(case: PolicyCase, device, seed: int = 0):
    """``(q, k, v, policy)`` for ``case``, made from a numpy seed."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            device, case.dtype)

    q = randn(case.b, case.s, case.h, case.d)
    k, v = (randn(case.b, case.s, case.hkv, case.d) for _ in range(2))
    u = rng.random((case.b, case.s), dtype=np.float32)
    pol = {"zeros": np.zeros_like(u), "ones": np.ones_like(u), "soft": u,
           "mixed": np.where(u < 0.5, 0.0, np.where(u < 0.8, 1.0, u)).astype(np.float32)
           }[case.policy]
    return q, k, v, torch.from_numpy(pol).to(device)


def check_policy_case(case: PolicyCase, device="cuda") -> Tuple[float, float]:
    """Runs K4 on ``case`` twice (equal bits) and holds it against the plain
    version in fp32 on the same values; returns (max abs error, max abs error
    of the plain version rounded to the case's dtype), raises
    ``AssertionError`` on a mismatch."""
    q, k, v, pol = make_policy_inputs(case, device)
    out = flash_policy_attention(q, k, v, pol)
    again = flash_policy_attention(q, k, v, pol)
    ref = flash_policy_attention_plain(q.float(), k.float(), v.float(), pol)
    tol = FP32_TOL if case.dtype == torch.float32 else BF16_TOL
    assert out.dtype == case.dtype and out.shape == q.shape, (out.dtype, out.shape)
    assert bool(torch.isfinite(out).all()), f"K4 {case.label}: non-finite output"
    err = (out.float() - ref).abs().max().item()
    assert torch.allclose(out.float(), ref, atol=tol, rtol=tol), (
        f"K4 {case.label}: kernel disagrees with its plain version, max_abs_err {err:.3e} "
        f"(atol=rtol={tol:g})")
    assert torch.equal(out, again), f"K4 {case.label}: two launches differ"
    rounding = (ref.to(case.dtype).float() - ref).abs().max().item()
    return err, rounding


def describe_policy_case(case: PolicyCase) -> str:
    return (f"K4 {case.label} [B={case.b} S={case.s} H={case.h} Hkv={case.hkv} d={case.d} "
            f"{case.dtype} policy {case.policy}]")


class MlpCase(NamedTuple):
    label: str
    k: int  # x's columns, the rows of gate and up
    f: int  # hidden columns, the rows of down
    d: int  # output columns


# the 7B and 13B decoders' MLPs: timed by chip_smoke.py at every QUANT_ROWS
# row count
MLP_CASES = [MlpCase("7B", 4096, 11008, 4096), MlpCase("13B", 5120, 13824, 5120)]
# the edges of the kernel's tiling (256 columns, units of 128 K rows in the
# gate/up phase and 256 F rows in the down phase): F and D that end inside a
# tile, K that ends inside a unit with narrow last tiles, both phases
# unsliced, and gate/up unsliced with two units a cell
MLP_EDGE_CASES = [
    MlpCase("F, D not multiples of 256", 384, 640, 320),
    MlpCase("K inside a unit, narrow last tiles", 4112, 1088, 576),
    MlpCase("unsliced, one tile", 64, 256, 64),
    MlpCase("unsliced gate/up, two units a cell", 256, 25600, 128),
]
MLP_EDGE_ROWS = (1, 7, 17, 64)
# bf16 / fp32 output, relative to max |ref|. The fp32 figure is not 1e-4: the
# kernel's and the plain version's fp32 sums run in different orders, so about
# one h in a thousand rounds to the other bf16 neighbour, and each moves an
# output by 2^-8 of one of its F terms.
MLP_TOL = {False: 1e-2, True: 1e-3}


def make_mlp_weights(case: MlpCase, device, gen, copies: int = 1):
    """``copies`` sets of random packed int4 weights ``(gate, up, down)`` and
    one set of bf16 scales for ``case``."""
    def packed(r, c):
        return torch.randint(-128, 128, (r, c), generator=gen, device=device, dtype=torch.int8)

    weights = [(packed(case.k, case.f // 2), packed(case.k, case.f // 2),
                packed(case.f, case.d // 2)) for _ in range(copies)]
    scales = [torch.rand(1, n, generator=gen, device=device).mul_(0.02 / 7).bfloat16()
              for n in (case.f, case.f, case.d)]
    return weights, scales


def check_mlp_case(case: MlpCase, rows: int, fp32: bool, device="cuda", gen=None,
                   weights=None, scales=None):
    """Runs K9 on ``case`` twice (equal bits) with bf16 x and output, or fp32
    x and output (``fp32``), and holds it against ``q4_mlp_plain``; returns
    (max abs error, that over max |ref|, x), raises ``AssertionError`` on a
    mismatch."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    if weights is None:
        (weights,), scales = make_mlp_weights(case, device, gen)
    x = torch.randn(rows, case.k, generator=gen, device=device)
    x = x if fp32 else x.bfloat16()
    got = qm.q4_mlp(x, *weights, *scales, out_fp32=fp32)
    again = qm.q4_mlp(x, *weights, *scales, out_fp32=fp32)
    want = qm.q4_mlp_plain(x, *weights, *scales, out_fp32=fp32)
    label = f"q4_mlp {case.label} rows={rows}{' fp32' if fp32 else ''}"
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape)
    assert bool(torch.isfinite(got).all()), f"{label}: non-finite output"
    assert torch.equal(got, again), f"{label}: two launches differ"
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    assert rel <= MLP_TOL[fp32], (f"{label}: kernel disagrees with its plain version, max err "
                                  f"/ max |ref| {rel:.3e} (tol {MLP_TOL[fp32]:g})")
    return err, rel, x


# the serving path's kernels: a pattern of the name the card reports
# (demangled, or mangled as the compiler emits it) and the wrappers that
# launch the kernel (a GEMV wrapper and its group form share one kernel)
SERVING_KERNELS = {
    "flash_fwd": (r"flash_fwd_(?:mma_)?kernel[<I]", (fa.flash_attention,)),
    "decode_kernel": (r"decode_kernel[<I]", (decode_attention,)),
    "extend_kernel": (r"extend_(?:mma_)?kernel[<I]", (extend_attention,)),
    "gemv int8": (r"gemv_(?:tc|fma)_kernel(?:<\d+, false>|ILi\d+ELb0E)",
                  (qm.q8_gemv, qm.q8_gemv_group)),
    "gemv int4": (r"gemv_(?:tc|fma)_kernel(?:<\d+, true>|ILi\d+ELb1E)",
                  (qm.q4_gemv, qm.q4_gemv_group)),
    "q4_mlp_kernel": (r"q4_mlp_kernel[<I]", (qm.q4_mlp,)),
}


TRACE_MARGIN_S = 0.5
# kernels that no count reads, at each end of a trace: a trace loses a few
# records at its start (more the longer the process has run), and up to
# ~0.2 s of records at an edge where the profiler's clock conversion is off
TRACE_PAD_KERNELS = 1024
# traces taken by ``kernel_launches``, the kernel records they read, and
# the seconds they cost beyond the calls they wrap (the margins, the
# padding, the profiler's start and stop, reading the records)
TRACE_COST = {"traces": 0, "records": 0, "seconds": 0.0}


def serving_kernel(name: str) -> Optional[str]:
    """The ``SERVING_KERNELS`` label of a kernel name, or None."""
    for label, (pattern, _) in SERVING_KERNELS.items():
        if re.search(pattern, name):
            return label
    return None


def device_launches(fn: Callable):
    """``(fn(), launches)``: the serving kernels' launches on the card while
    ``fn`` runs, by ``SERVING_KERNELS`` label, counted in one
    ``torch.profiler`` trace of the CUDA activity (``kernel_launches``)."""
    out, names = kernel_launches(fn)
    launches: Dict[str, int] = dict.fromkeys(SERVING_KERNELS, 0)
    for name, n in names.items():
        label = serving_kernel(name)
        if label is not None:
            launches[label] += n
    return out, launches


def kernel_launches(fn: Callable):
    """``(fn(), Counter of kernel name -> launches)`` on the card while
    ``fn`` runs, from one ``torch.profiler`` trace of the CUDA activity (a
    graph replay's kernels are recorded one by one). The profiler drops
    events at the edges of its trace, so ``fn``'s work sits between
    ``TRACE_PAD_KERNELS`` kernels of no serving kernel's name and
    ``TRACE_MARGIN_S`` of idle card at each end. kineto stops collecting
    once a trace's GPU records pass its cap (128 MB unless a kineto config
    raises it, ``KINETO_CONFIG``: ``chip_smoke.py`` points it at
    ``kineto.conf`` beside this module), and the trace then loses its end: a
    256-step decode call at B=8 records ~108 MB."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device=torch.device("cuda", torch.cuda.current_device()))

    def padding():
        for _ in range(TRACE_PAD_KERNELS):
            pad.add_(1)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        padding()
        t_fn = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t_fn = time.perf_counter() - t_fn
        padding()
        time.sleep(TRACE_MARGIN_S)
    names = Counter(e.name() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA)
    TRACE_COST["traces"] += 1
    TRACE_COST["records"] += sum(names.values())
    TRACE_COST["seconds"] += time.perf_counter() - t0 - t_fn
    return out, names


def wrapper_calls(before: Dict, after: Dict) -> Dict[str, int]:
    """Host calls of each serving kernel's wrappers between two readings of
    ``{wrapper: wrapper.launches}``, by ``SERVING_KERNELS`` label."""
    return {label: sum(after[fn] - before[fn] for fn in fns)
            for label, (_, fns) in SERVING_KERNELS.items()}


def read_counters() -> Dict:
    """``{wrapper: wrapper.launches}`` of the serving kernels' wrappers."""
    return {fn: fn.launches for _, fns in SERVING_KERNELS.values() for fn in fns}
