"""CPU side of the redesigned policy attention (K4) and fused int4 MLP (K9):
the wrappers' plain paths against the JAX functions on the same numpy
inputs at the edge shapes the card-side cases use
(``dynamic_llava_tpu_torch/kernel_cases.py``), and the host-side arithmetic
that K9's launch rests on (its two work lists, ``mlp_plan``) for every shape
the configs produce.

Tolerances: policy attention in fp32, atol 3e-5 / rtol 3e-4 (the tolerance
of the JAX package's own test and of ``test_k4_plain_matches_pallas_interpret``:
sums over up to 129 keys in another order); the MLP with bf16 output atol =
rtol = 2e-2 and with fp32 output 2e-3, as ``tests/test_torch_q4_mlp.py``
states them (the Pallas kernel sums K in windows, so an ``h`` may round to
the neighbouring bf16 value). The Pallas kernels run in interpret mode.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import LlamaConfig
from dynamic_llava_tpu.ops import flash_policy as jpolicy
from dynamic_llava_tpu.ops import quant as jq
from dynamic_llava_tpu.ops import quant_matmul as jqm
from dynamic_llava_tpu_torch import kernel_cases as kc
from dynamic_llava_tpu_torch import kernels
from dynamic_llava_tpu_torch.ops import flash_policy as tpolicy
from dynamic_llava_tpu_torch.ops import quant_matmul as tqm


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# K4: the plain path against the Pallas policy kernel at the tile edges
# ---------------------------------------------------------------------------


def _policy(kind, b, s, seed):
    u = np.random.default_rng(seed).random((b, s), dtype=np.float32)
    return {"zeros": np.zeros_like(u), "ones": np.ones_like(u), "soft": u}[kind]


@pytest.mark.parametrize("kind", ["zeros", "ones", "soft"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 129])
def test_policy_plain_matches_pallas_at_the_tile_edges(s, d, kind):
    """S at and around the 64-row tiles of the card's kernel, 4 query heads
    a kv head, a policy that drops every column but the diagonal, keeps every
    column, or is soft. The Pallas kernel runs with 64-row blocks too, so its
    causal skip and tail sum of v meet the same edges."""
    b, h, hkv = 2, 4, 1
    q, k, v = _np((b, s, h, d), s + d), _np((b, s, hkv, d), s + d + 1), \
        _np((b, s, hkv, d), s + d + 2)
    pol = _policy(kind, b, s, s + d + 3)
    want = jpolicy.flash_policy_attention(
        *map(jnp.asarray, (q, k, v, pol)), block_q=64, block_k=64, interpret=True)
    ins = [torch.from_numpy(a) for a in (q, k, v, pol)]
    got = tpolicy.flash_policy_attention_plain(*ins)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=3e-4)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(got, tpolicy.flash_policy_attention(*ins))


def test_policy_edge_cases_cover_the_tile_edges():
    """The card-side list holds every edge the test above checks on the CPU,
    in bf16 and fp32."""
    got = {(c.s, c.d, c.policy, c.dtype, c.h // c.hkv) for c in kc.POLICY_EDGE_CASES}
    want = {(s, d, kind, dtype, 4) for s in (1, 63, 64, 65, 129) for d in (64, 128)
            for kind in ("zeros", "ones", "soft") for dtype in (kc.BF16, kc.FP32)}
    assert got == want


# ---------------------------------------------------------------------------
# K9: the plain path against the Pallas MLP kernel with F and D off 256
# ---------------------------------------------------------------------------

# F and D that are not multiples of 256 (the card kernel's tile width); the
# Pallas planner takes them, as multiples of 128, and K = 384 (three of its
# 128-row windows)
K_DIM, F_DIM, D_DIM = 384, 640, 320


@pytest.fixture(scope="module")
def mlp_leaves():
    """JAX int4 leaves ``{"q4", "s"}`` of bf16 gate, up ``[K, F]`` and down
    ``[F, D]``, and their torch copies."""
    shapes = {"gate": (K_DIM, F_DIM), "up": (K_DIM, F_DIM), "down": (F_DIM, D_DIM)}
    jl = {n: jq.quantize_weight(jnp.asarray(_np(shape, 50 + i, 0.05), jnp.bfloat16), axis=0,
                                bits=4) for i, (n, shape) in enumerate(shapes.items())}
    tl = {n: {key: torch.from_numpy(np.asarray(val, np.float32)).bfloat16()
              if key == "s" else torch.from_numpy(np.array(val))
              for key, val in leaf.items()} for n, leaf in jl.items()}
    return jl, tl


@pytest.mark.parametrize("rows", [1, 7, 17, 64])
def test_q4_mlp_plain_matches_pallas_off_256(mlp_leaves, rows):
    jl, tl = mlp_leaves
    names = ("gate", "up", "down")
    assert F_DIM % 256 and D_DIM % 256
    x = _np((rows, K_DIM), 200 + rows)
    for out_fp32, tol in ((False, 2e-2), (True, 2e-3)):
        jx = jnp.asarray(x, jnp.float32 if out_fp32 else jnp.bfloat16)
        tx = torch.from_numpy(x) if out_fp32 else torch.from_numpy(x).bfloat16()
        want = jqm.matmul_q4_mlp_pallas(
            jx, *(jl[n]["q4"] for n in names), *(jl[n]["s"] for n in names),
            out_fp32=out_fp32, interpret=True)
        got = tqm.q4_mlp_plain(tx, *(tl[n]["q4"] for n in names), *(tl[n]["s"] for n in names),
                               out_fp32=out_fp32)
        assert got.dtype == (torch.float32 if out_fp32 else torch.bfloat16)
        assert tuple(got.shape) == (rows, D_DIM)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
        # the wrapper takes the plain version for CPU tensors
        again = tqm.q4_mlp(tx, *(tl[n]["q4"] for n in names), *(tl[n]["s"] for n in names),
                           out_fp32=out_fp32)
        assert torch.equal(got, again)


# ---------------------------------------------------------------------------
# K9: the two work lists of one launch
# ---------------------------------------------------------------------------


def _config_mlps():
    """(label, K, F, D) of every MLP the decoder configs make (tiny, the
    small model ``chip_smoke.py`` checks against the CPU, 7B, 13B) and of the
    card-side case lists."""
    cfgs = {"tiny": LlamaConfig.tiny(), "small": LlamaConfig.tiny(hidden_size=256,
                                                                 intermediate_size=512),
            "7b": LlamaConfig(), "13b": LlamaConfig.llama_13b()}
    for name, cfg in cfgs.items():
        yield name, cfg.hidden_size, cfg.intermediate_size, cfg.hidden_size
    for c in kc.MLP_CASES + kc.MLP_EDGE_CASES:
        yield c.label, c.k, c.f, c.d


CONFIG_MLPS = list(_config_mlps())
MLP_ROWS = [1, 7, 8, 16, 17, 24, 32, 33, 64]


def _align256(n):
    return -(-n // 256) * 256


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("case", CONFIG_MLPS, ids=[c[0] for c in CONFIG_MLPS])
def test_mlp_plan_covers_every_unit_once(case, sms):
    _, k, f, d = case
    for rows in MLP_ROWS:
        plan = tqm.mlp_plan(rows, k, f, d, sms)
        mt = 16 if rows <= 16 else 32 if rows <= 32 else 64
        parts = []
        # phase A: 256 columns of F in gate AND up, units of 128 K rows;
        # phase B: 256 columns of D in down, units of 256 F rows
        for phase, n, kk, unit_rows, weights in ((plan.gate_up, f, k, 128, 2),
                                                 (plan.down, d, f, 256, 1)):
            assert phase.tiles == -(-n // tqm.ITEM_COLS)
            assert phase.unit_rows == unit_rows
            assert phase.unit_rows * weights * tqm.ITEM_COLS // 2 == tqm.UNIT_BYTES
            units = -(-kk // unit_rows)
            cells = phase.tiles * phase.slices
            assert 1 <= phase.slices <= min(tqm.MAX_SLICES, units)
            assert phase.grid == sms  # one persistent block an SM for both phases
            # every cell belongs to exactly one block
            owned = sorted(c for b in range(sms) for c in phase.block_cells(b))
            assert owned == list(range(cells))
            # the units of every tile are covered once, slice by slice in order
            for tile in range(phase.tiles):
                covered = [u for s in range(phase.slices)
                           for u in phase.cell_units(s * phase.tiles + tile, kk)]
                assert covered == list(range(units))
                assert all(len(phase.cell_units(s * phase.tiles + tile, kk)) >= 1
                           for s in range(phase.slices))
            # the partial tiles: two weights' (phase A) or one's a cell, sliced only
            want = 0 if phase.slices == 1 else weights * 4 * mt * tqm.ITEM_COLS * cells
            assert phase.scratch_bytes == want
            parts.append(want)
            # the waves' cost is within a unit and a quarter of an even share
            waves = -(-cells // sms)
            assert waves * phase.chunks <= 1.25 * phase.tiles * units / min(sms, cells) + 1
        assert plan.tickets == plan.gate_up.tiles + plan.down.tiles <= kernels.TICKETS
        assert plan.scratch_bytes == _align256(2 * rows * f) + sum(map(_align256, parts))


def test_mlp_plan_at_the_7b_and_13b_shapes():
    """The plans PERF.md's times were taken with (132 SMs)."""
    plan = tqm.mlp_plan(8, 4096, 11008, 4096, 132)
    assert (plan.gate_up.tiles, plan.gate_up.slices, plan.gate_up.chunks) == (43, 3, 11)
    assert (plan.down.tiles, plan.down.slices, plan.down.chunks) == (16, 8, 6)
    plan = tqm.mlp_plan(8, 5120, 13824, 5120, 132)
    assert (plan.gate_up.tiles, plan.gate_up.slices, plan.gate_up.chunks) == (54, 2, 20)
    assert (plan.down.tiles, plan.down.slices, plan.down.chunks) == (20, 6, 9)
