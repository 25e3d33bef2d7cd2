"""CPU side of the redesigned decode attention (K2) and weight-only GEMVs
(K5-K8): the wrappers' plain paths against the JAX functions on the same
numpy inputs at the edge shapes the card-side cases use, and the host-side
arithmetic that the kernels' launches rest on (the split of K2's cache length
over blocks, the GEMV work list), for every shape the configs produce.

Tolerances: decode attention in fp32, atol 1e-5 / rtol 1e-4 (fp32 sums in
another order); GEMVs with fp32 output atol 1e-5 / rtol 1e-4, with bf16
output rtol 8e-3 (one bf16 rounding of the same fp32 sum). The Pallas GEMV
kernels run in interpret mode, as ``tests/test_torch_quant.py`` runs them.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import LlamaConfig
from dynamic_llava_tpu.ops import attention as jattn
from dynamic_llava_tpu.ops import kv_cache as jkv
from dynamic_llava_tpu.ops import quant as jq
from dynamic_llava_tpu.ops import quant_matmul as jqm
from dynamic_llava_tpu_torch import kernel_cases as kc
from dynamic_llava_tpu_torch.ops import decode_attention as tda
from dynamic_llava_tpu_torch.ops import kv_cache as tkv
from dynamic_llava_tpu_torch.ops import quant_matmul as tqm

ATOL, RTOL = 1e-5, 1e-4
FP8 = torch.float8_e4m3fn
SMS = 132  # an H100 SXM


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# K2: the wrapper's plain path against the JAX decode_attend_appended
# ---------------------------------------------------------------------------

# (label, B, max_len, H, Hkv, d, bounds, window): the card-side edges at a
# CPU size: lengths 0 and 1, around a 64-row tile / split edge, at the
# capacity and past it, 4 and 8 query heads a kv head, head_dim 64, a window
# whose first row falls inside the second 64-row split
ATTEND_CASES = [
    ("lengths 0, 1, edges", 6, 130, 4, 2, 16, [0, 1, 63, 64, 65, 129], None),
    ("at and past the capacity", 3, 128, 4, 4, 16, [127, 128, 200], None),
    ("gqa 4, d 64", 4, 96, 8, 2, 64, [0, 31, 64, 96], None),
    ("gqa 8", 3, 70, 8, 1, 32, [1, 33, 70], None),
    ("window inside a split", 4, 192, 4, 2, 16, [70, 100, 150, 191], 40),
    ("window wider than the cache", 2, 64, 4, 2, 16, [10, 64], 500),
]


@pytest.mark.parametrize("store", ["own", "int8", "fp8"])
@pytest.mark.parametrize("case", ATTEND_CASES, ids=[c[0] for c in ATTEND_CASES])
def test_decode_attention_plain_path_matches_jax_at_the_edges(case, store):
    _, b, max_len, h, hkv, d, bounds, window = case
    q, kn, vn = _np((b, 1, h, d), 1), _np((b, 1, hkv, d), 2), _np((b, 1, hkv, d), 3)
    kf, vf = _np((b, max_len, hkv, d), 4), _np((b, max_len, hkv, d), 5)
    jkw, tkw = {}, {}
    if store == "int8":
        jk, jkw["k_scale"] = jkv.quantize_kv(jnp.asarray(kf))
        jv, jkw["v_scale"] = jkv.quantize_kv(jnp.asarray(vf))
        tk, tkw["k_scale"] = tkv.quantize_kv(torch.from_numpy(kf))
        tv, tkw["v_scale"] = tkv.quantize_kv(torch.from_numpy(vf))
    elif store == "fp8":
        jk, jv = (jnp.asarray(t).astype(jnp.float8_e4m3fn) for t in (kf, vf))
        tk, tv = (tkv.to_storage(torch.from_numpy(t), FP8) for t in (kf, vf))
    else:
        jk, jv, tk, tv = jnp.asarray(kf), jnp.asarray(vf), torch.from_numpy(kf), \
            torch.from_numpy(vf)
    bound = np.asarray(bounds, np.int32)
    if window is not None:
        q_pos = np.minimum(bound, max_len) + 3
        jkw.update(window=window, q_pos=jnp.asarray(q_pos))
        tkw.update(window=window, q_pos=torch.from_numpy(q_pos))
    want = jattn.decode_attend_appended(
        jnp.asarray(q), jk, jv, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(bound), **jkw)
    got = tda.decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(bound), **tkw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, 1, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_a_bound_past_the_capacity_is_the_capacity():
    """The kernel clamps the bound to the cache's capacity; so does the
    plain version it is held against."""
    _, b, max_len, h, hkv, d, _, _ = ATTEND_CASES[1]
    args = [torch.from_numpy(a) for a in (
        _np((b, 1, h, d), 1), _np((b, max_len, hkv, d), 4), _np((b, max_len, hkv, d), 5),
        _np((b, 1, hkv, d), 2), _np((b, 1, hkv, d), 3))]
    past = tda.decode_attention(*args, torch.tensor([128, 129, 4000], dtype=torch.int32))
    full = tda.decode_attention(*args, torch.full((b,), max_len, dtype=torch.int32))
    torch.testing.assert_close(past, full, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# K2: the split of the cache length over blocks
# ---------------------------------------------------------------------------

# (B, Hkv, max_len) the serving configs produce: 7B and 13B heads, the tiers
# chip_smoke.py serves (768 / 256), B = 1, 4 and 8, longer caches, GQA
SPLIT_SHAPES = [(b, hkv, max_len) for b in (1, 2, 4, 8, 16) for hkv in (1, 2, 8, 32, 40)
                for max_len in (8, 63, 64, 256, 768, 1024, 4096, 32768)]


@pytest.mark.parametrize("b,hkv,max_len", SPLIT_SHAPES)
def test_decode_split_is_bounded_and_fills_the_card(b, hkv, max_len):
    n = tda.decode_split(b, hkv, max_len)
    assert 1 <= n <= tda.MAX_SPLIT
    chunk = -(-max_len // n)  # rows a block owns (csrc/decode_attention.cu)
    assert n * chunk >= max_len  # every cache row belongs to a split
    assert n == 1 or chunk >= tda.SPLIT_MIN_ROWS  # no block owns a sliver
    if n > 1:  # one split fewer would leave SMs without a block
        assert b * hkv * (n - 1) < tda.SPLIT_TARGET_BLOCKS
    if b * hkv >= tda.SPLIT_TARGET_BLOCKS or max_len < 2 * tda.SPLIT_MIN_ROWS:
        assert n == 1


def test_decode_split_at_the_served_shapes():
    assert tda.decode_split(8, 32, 768) == 1 and tda.decode_split(4, 32, 256) == 1
    assert tda.decode_split(1, 40, 768) == 4  # 13B, one request: 160 blocks
    assert tda.decode_split(1, 32, 32768) == 4
    assert tda.decode_split(1, 1, 32768) == tda.MAX_SPLIT


# ---------------------------------------------------------------------------
# K5-K8: the wrappers' plain paths against the Pallas kernels at the new edges
# ---------------------------------------------------------------------------


def _bf16_values(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _weights(k, ns, bits, seed):
    leaves = [jq.quantize_weight(jnp.asarray(_np((k, n), seed + i, 0.02)), axis=0, bits=bits)
              for i, n in enumerate(ns)]
    key = "q4" if bits == 4 else "q"
    return [l[key] for l in leaves], [l["s"] for l in leaves]


def _to_torch(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.float32)) if a.dtype.kind == "f" else torch.from_numpy(a)


# (label, K, output widths): a three-weight group of unequal widths, widths
# that end inside a 256-column tile, K that ends inside a k16 step (the Pallas
# kernels take K in multiples of 128, so the odd K are held against the XLA
# reference below), rows at every tier's edge
GEMV_EDGES = [
    ("unequal group", 256, [320, 64, 128]),
    ("one narrow tile", 128, [64]),
    ("past one tile", 128, [320]),
    ("two weights, K = 384", 384, [192, 448]),
]
GEMV_ROWS = [1, 16, 17, 33, 64]


@pytest.mark.parametrize("rows", GEMV_ROWS)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", GEMV_EDGES, ids=[c[0] for c in GEMV_EDGES])
def test_gemv_plain_path_matches_pallas_at_the_edges(case, bits, rows):
    _, k, ns = case
    group = len(ns) > 1
    ws, ss = _weights(k, ns, bits, seed=rows)
    tw, ts = [_to_torch(w) for w in ws], [_to_torch(s) for s in ss]
    for out_fp32 in (False, True):
        x = _bf16_values(_np((rows, k), 100 + rows))
        jx = jnp.asarray(x, jnp.float32 if out_fp32 else jnp.bfloat16)
        tx = torch.from_numpy(x) if out_fp32 else torch.from_numpy(x).bfloat16()
        if group:
            pallas = jqm.matmul_q4_multi_pallas if bits == 4 else jqm.matmul_q8_multi_pallas
            port = tqm.q4_gemv_group if bits == 4 else tqm.q8_gemv_group
            want = pallas(jx, tuple(ws), tuple(ss), out_fp32=out_fp32, interpret=True)
            got = port(tx, tw, ts, out_fp32=out_fp32)
        else:
            pallas = jqm.matmul_q4_pallas if bits == 4 else jqm.matmul_q8_pallas
            port = tqm.q4_gemv if bits == 4 else tqm.q8_gemv
            want = [pallas(jx, ws[0], ss[0], out_fp32=out_fp32, interpret=True)]
            got = [port(tx, tw[0], ts[0], out_fp32=out_fp32)]
        assert len(got) == len(want) == len(ns)
        for g, w, n in zip(got, want, ns):
            assert tuple(g.shape) == (rows, n)
            w = np.asarray(w, np.float32)
            if out_fp32:
                assert g.dtype == torch.float32
                np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)
            else:
                assert g.dtype == torch.bfloat16
                np.testing.assert_allclose(g.float().numpy(), w, atol=1e-6, rtol=8e-3)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [8, 72, 264])
def test_gemv_plain_path_matches_the_jax_reference_at_odd_k(k, bits):
    """K that is a multiple of 8 and not of 16 or 128 (the CUDA kernels take
    it; the Pallas kernels do not): against the JAX package's XLA matmul on
    the same quantized leaf, fp32 x and output."""
    n = 192
    leaf = jq.quantize_weight(jnp.asarray(_np((k, n), 7, 0.02)), axis=0, bits=bits)
    x = _bf16_values(_np((5, k), 8))
    want = (jq.matmul_q4 if bits == 4 else jq.matmul_q8)(jnp.asarray(x), leaf, out_fp32=True)
    port = tqm.q4_gemv if bits == 4 else tqm.q8_gemv
    got = port(torch.from_numpy(x), _to_torch(leaf["q4" if bits == 4 else "q"]),
               _to_torch(leaf["s"]), out_fp32=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# K5-K8: the work list of the bf16-x kernel
# ---------------------------------------------------------------------------


def _config_gemvs():
    """(label, K, output widths) of every GEMV launch the decoder configs
    make: q/k/v, o, gate/up, down and the lm_head, for the 7B, 13B, tiny and
    Mistral-style GQA decoders."""
    cfgs = {
        "7b": LlamaConfig(), "13b": LlamaConfig.llama_13b(), "tiny": LlamaConfig.tiny(),
        "7b-gqa": LlamaConfig(num_key_value_heads=8),
    }
    for name, cfg in cfgs.items():
        d, f = cfg.hidden_size, cfg.intermediate_size
        hd = d // cfg.num_attention_heads
        kv = cfg.num_key_value_heads * hd
        vocab = -(-cfg.vocab_size // 64) * 64
        yield f"{name} q/k/v", d, (d, kv, kv)
        yield f"{name} o", d, (d,)
        yield f"{name} gate/up", d, (f, f)
        yield f"{name} down", f, (d,)
        yield f"{name} lm_head", d, (vocab,)


CONFIG_GEMVS = list(_config_gemvs()) + [(c.label, c.k, c.ns)
                                        for c in kc.QUANT_CASES + kc.QUANT_EDGE_CASES]


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("case", CONFIG_GEMVS, ids=[c[0] for c in CONFIG_GEMVS])
def test_gemv_plan_covers_every_unit_once(case, int4):
    _, k, ns = case
    for rows in (1, 8, 17, 64):
        plan = tqm.gemv_plan(rows, k, tuple(ns), int4, SMS)
        assert plan.tiles == sum(-(-n // tqm.ITEM_COLS) for n in ns)
        assert plan.unit_rows * (tqm.ITEM_COLS // 2 if int4 else tqm.ITEM_COLS) == tqm.UNIT_BYTES
        units = -(-k // plan.unit_rows)
        cells = plan.tiles * plan.slices
        assert 1 <= plan.slices <= min(tqm.MAX_SLICES, units)
        assert 1 <= plan.grid == min(SMS, cells)
        # every cell belongs to exactly one block, every unit of a tile to one cell
        owned = sorted(c for b in range(plan.grid) for c in plan.block_cells(b))
        assert owned == list(range(cells))
        for tile in (0, plan.tiles - 1):
            covered = [u for s in range(plan.slices)
                       for u in plan.cell_units(s * plan.tiles + tile, k)]
            assert covered == list(range(units))
            assert all(len(plan.cell_units(s * plan.tiles + tile, k)) >= 1
                       for s in range(plan.slices))
        # the scratch: a partial tile a cell of a sliced launch, none otherwise
        mt = 16 if rows <= 16 else 32 if rows <= 32 else 64
        want = 0 if plan.slices == 1 else 4 * cells * mt * tqm.ITEM_COLS
        assert plan.scratch_bytes == want
        # the waves' cost is within a unit and a quarter of an even share
        waves = -(-cells // SMS)
        assert waves * plan.chunks <= 1.25 * plan.tiles * units / min(SMS, cells) + 1


def test_gemv_plan_at_the_7b_shapes():
    """The plans PERF.md's times were taken with (132 SMs)."""
    plan = tqm.gemv_plan(8, 4096, (4096,), False, SMS)  # o, int8: 16 tiles cut in 8
    assert (plan.tiles, plan.slices, plan.chunks, plan.grid) == (16, 8, 4, 128)
    plan = tqm.gemv_plan(8, 4096, (11008, 11008), False, SMS)  # gate/up, int8
    assert (plan.tiles, plan.slices, plan.chunks, plan.grid) == (86, 3, 11, 132)
    plan = tqm.gemv_plan(8, 4096, (32000,), True, SMS)  # lm_head, int4: unsliced
    assert (plan.tiles, plan.slices, plan.chunks, plan.scratch_bytes) == (125, 1, 16, 0)
