"""The host side of K2-M's tensor-core form (``extend_mma_kernel``), on the
CPU:

(a) ``extend_plan``, the wrapper's plan of a call: which kernel takes it
(a bf16 q over a bf16, int8 or fp8 cache: the tensor cores, in tiles of 64
query rows; anything else: the CUDA cores, in groups of 8), the row tiles,
the length split, the workspace and the tickets, as a pure function of the
shapes. The workspace is held against every byte the kernels' address
arithmetic (``csrc/extend_attention.cu``, ``csrc/decode_attention.cu``)
writes, and the plan to about one block an SM at the chat and verify
shapes.
(b) ``kernel_cases.serving_kernel``: the names the card reports for both
M-query kernels map to the ``extend_kernel`` label, no ``decode_kernel``
name does.
(c) The wrapper's CPU path (``extend_attend_appended`` under
``extend_mask``) against the JAX ``extend_attend_appended`` under the mask
the JAX ``run_layers_extend`` builds, at the card cases that sit on the new
tiles' edges (``kernel_cases.EXTEND_CASES``: M x n_rep at 16, 17, 63, 64,
65, 128, 129 and the multiples of 4 beside them, 8 query heads a kv head, a
64-row tile across a window start, chunk_attend all false), every storage
type, fp32 (atol 1e-5, rtol 1e-4).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.ops import attention as jattn
from dynamic_llava_tpu_torch import kernel_cases as kc
from dynamic_llava_tpu_torch import kernels
from dynamic_llava_tpu_torch.ops import decode_attention as tda

from test_torch_extend import jax_extend_mask

ATOL, RTOL = 1e-5, 1e-4
BF16, FP32 = torch.bfloat16, torch.float32
STORES = (BF16, FP32, torch.int8, torch.float8_e4m3fn)

# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------

# (B, M, H, Hkv, d, max_len): the chat and verify shapes of the 7B decoder,
# the 13B heads, GQA 4 and 8, M x n_rep at and beside the 16- and 64-row
# edges, caches from one tile to the split cap
PLAN_SHAPES = [
    (1, 40, 32, 32, 128, 1088), (1, 100, 32, 32, 128, 1088),
    (1, 5, 32, 32, 128, 320), (8, 8, 32, 32, 128, 320), (1, 40, 40, 40, 128, 768),
    (3, 17, 8, 2, 64, 320), (2, 9, 16, 2, 128, 256), (1, 129, 2, 2, 128, 333),
    (4, 1, 4, 4, 64, 64), (1, 64, 8, 1, 64, 4096), (16, 33, 8, 2, 128, 32768),
    (1, 16, 1, 1, 64, 2048),
]


def kernel_extent(plan, b, m, h, hkv, d):
    """Floats of the workspace the kernel of ``plan`` writes, at most: for
    each (sample, kv head, row tile, split) a region of ``rows`` rows, acc
    [rows][d] then (m, l) of each row, 2 floats (CUDA cores) or 4 (tensor
    cores, for 16-byte rows); region r starts at r x region size
    (``csrc/decode_attention.cu`` attend_block, ``csrc/extend_attention.cu``
    extend_mma_kernel). Returns (end of the last region written, the size of
    a region, the floats a region's writes reach)."""
    rows = min(m * (h // hkv), plan.block_rows)
    per_row = 4 if plan.tensor_cores else 2
    region = rows * (d + per_row)
    reach = rows * d + per_row * (rows - 1) + 2  # the last row's (m, l)
    regions = b * hkv * plan.row_tiles * plan.n_split
    return (regions - 1) * region + reach, region, reach


@pytest.mark.parametrize("store", STORES, ids=str)
@pytest.mark.parametrize("q_dtype", (BF16, FP32), ids=str)
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_extend_plan_is_a_function_of_the_shapes(shape, q_dtype, store):
    b, m, h, hkv, d, max_len = shape
    plan = tda.extend_plan(b, m, h, hkv, d, max_len, q_dtype, store)
    assert plan == tda.extend_plan(b, m, h, hkv, d, max_len, q_dtype, store)
    tc = q_dtype == BF16 and store != FP32
    assert plan.tensor_cores == tc
    assert plan.block_rows == (tda.MMA_ROWS if tc else tda.MAX_Q)
    assert plan.row_tiles == -(-m * (h // hkv) // plan.block_rows)
    target = tda.MMA_SPLIT_TARGET_BLOCKS if tc else tda.SPLIT_TARGET_BLOCKS
    assert plan.n_split == tda.decode_split(b * plan.row_tiles, hkv, max_len, target)
    assert 1 <= plan.n_split <= tda.MAX_SPLIT
    if plan.n_split == 1:
        assert plan.workspace_bytes == 0 and plan.tickets == 0
        return
    # every region the kernel writes lies inside the workspace, and no two
    # overlap; one ticket for each (sample, kv head, row tile)
    end, region, reach = kernel_extent(plan, b, m, h, hkv, d)
    assert reach <= region
    assert 4 * end <= plan.workspace_bytes
    assert plan.workspace_bytes % 16 == 0 or not tc  # 16-byte rows on the tensor cores
    assert plan.tickets == b * hkv * plan.row_tiles <= kernels.TICKETS


# (shape, storage) -> (row tiles, splits) at the served shapes: the chat
# rounds 2 and 3 (pre tier 1088) and the verify rounds (post tier 320)
SERVED = {
    (1, 40, 1088): (1, 6), (1, 100, 1088): (2, 3), (1, 5, 320): (1, 5), (1, 8, 320): (1, 5),
    (8, 5, 320): (1, 1), (8, 8, 320): (1, 1),
}


@pytest.mark.parametrize("store", (BF16, torch.int8), ids=str)
@pytest.mark.parametrize("shape", list(SERVED), ids=lambda s: "x".join(map(str, s)))
def test_extend_plan_fills_the_card_at_the_served_shapes(shape, store):
    b, m, max_len = shape
    plan = tda.extend_plan(b, m, 32, 32, 128, max_len, BF16, store)
    assert plan.tensor_cores
    assert (plan.row_tiles, plan.n_split) == SERVED[shape]
    blocks = b * 32 * plan.row_tiles * plan.n_split
    # at least one block for each of the H100's 132 SMs, at most two (the
    # kernel's shared memory lets two share an SM)
    assert 132 <= blocks <= 2 * 132


def test_extend_plan_keeps_the_cuda_core_groups_for_fp32():
    plan = tda.extend_plan(4, 40, 8, 2, 128, 256, FP32, FP32)
    assert not plan.tensor_cores and plan.row_tiles == 20  # 160 rows in groups of 8
    assert tda.extend_plan(4, 40, 8, 2, 128, 256, BF16, FP32).tensor_cores is False


# ---------------------------------------------------------------------------
# (b) kernel names
# ---------------------------------------------------------------------------

_NS = "_ZN6dllava52_GLOBAL__N__a43fece6_19_extend_attention_cu_fc303037"
_DNS = "_ZN6dllava52_GLOBAL__N__6c6d5f17_19_decode_attention_cu_69089eeb"
M_QUERY_NAMES = {
    # the tensor-core form, mangled as the compiler emits it and demangled
    _NS + "17extend_mma_kernelI13__nv_bfloat16Li128ELi1EEEvNS0_7MmaArgsE": "extend_kernel",
    _NS + "17extend_mma_kernelIaLi64ELi4EEEvNS0_7MmaArgsE": "extend_kernel",
    _NS + "17extend_mma_kernelINS0_3Fp8ELi128ELi4EEEvNS0_7MmaArgsE": "extend_kernel",
    "void dllava::(anonymous namespace)::extend_mma_kernel<__nv_bfloat16, 128, 4>(dllava::"
    "(anonymous namespace)::MmaArgs)": "extend_kernel",
    "void dllava::(anonymous namespace)::extend_mma_kernel<signed char, 64, 1>(dllava::"
    "(anonymous namespace)::MmaArgs)": "extend_kernel",
    "void dllava::(anonymous namespace)::extend_mma_kernel<dllava::(anonymous namespace)::"
    "Fp8, 128, 1>(dllava::(anonymous namespace)::MmaArgs)": "extend_kernel",
    # the CUDA-core form
    _DNS + "13extend_kernelIfLi64EEEvNS0_10AttendArgsE": "extend_kernel",
    "void dllava::(anonymous namespace)::extend_kernel<float, 128>(dllava::(anonymous "
    "namespace)::AttendArgs)": "extend_kernel",
    # K2 is its own label
    _DNS + "13decode_kernelI13__nv_bfloat16Li128ELi1EEEvNS0_10AttendArgsE": "decode_kernel",
    "void dllava::(anonymous namespace)::decode_kernel<signed char, 64, 2>(dllava::"
    "(anonymous namespace)::AttendArgs)": "decode_kernel",
    _DNS + "13decode_kernelINS0_3Fp8ELi128ELi2EEEvNS0_10AttendArgsE": "decode_kernel",
}


@pytest.mark.parametrize("name", list(M_QUERY_NAMES), ids=lambda n: n[-60:])
def test_serving_kernel_names_of_both_m_query_kernels(name):
    assert kc.serving_kernel(name) == M_QUERY_NAMES[name]


# ---------------------------------------------------------------------------
# (c) the plain path at the new tiles' edge cases, against JAX
# ---------------------------------------------------------------------------

EDGE_CASES = [c for c in kc.EXTEND_CASES
              if c.label.startswith(("tile edge", "gqa 8", "tile across", "chunk_attend all"))]
_jextend = jax.jit(jattn.extend_attend_appended)


def _to_jax(t):
    """A stored torch tensor as the JAX array of the same bits."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn))
    return jnp.asarray(t.numpy())


def test_the_edge_cases_cover_the_new_tiles():
    rows = {c.m * c.h // c.hkv for c in EDGE_CASES}
    assert {16, 17, 63, 64, 65, 128, 129, 20, 60, 68, 132, 72} <= rows
    assert {c.storage for c in EDGE_CASES} == {"own", "int8", "fp8"}
    assert all(c.dtype == BF16 for c in EDGE_CASES)
    assert any(c.attend and c.attend_rate == 0 for c in EDGE_CASES)
    assert any(c.window and c.m == 64 for c in EDGE_CASES)


@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: c.label)
def test_extend_attention_cpu_path_matches_jax_at_the_tile_edges(case):
    (q, kcache, vcache, kn, vn, length), kw = kc.make_extend_inputs(case, "cpu")
    attend, positions = kw.get("chunk_attend"), kw.get("positions")
    # fp32 queries and chunk K/V (the bf16 values exactly), the stored cache
    q, kn, vn = q.float(), kn.float(), vn.float()
    got = tda.extend_attention(q, kcache, vcache, kn, vn, length, **kw)
    jmask = jax_extend_mask(jnp.asarray(length.numpy()), case.max_len, case.m,
                            None if attend is None else jnp.asarray(attend.numpy()),
                            case.window, None if positions is None else jnp.asarray(positions.numpy()))
    scales = {k: None if kw[k] is None else _to_jax(kw[k]) for k in ("k_scale", "v_scale")}
    want = np.asarray(_jextend(jnp.asarray(q.numpy()), _to_jax(kcache), _to_jax(vcache),
                               jnp.asarray(kn.numpy()), jnp.asarray(vn.numpy()), jmask,
                               **scales))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
