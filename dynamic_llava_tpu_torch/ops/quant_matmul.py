"""Weight-only int8 / int4 GEMVs and the fused int4 MLP: kernels K5-K9 and
their plain PyTorch versions.

Counterpart of ``dynamic_llava_tpu/ops/quant_matmul.py``:

* K5 ``q8_gemv`` -- ``_q8_gemv_kernel`` (``matmul_q8_pallas``);
* K6 ``q8_gemv_group`` -- ``_q8_gemv_multi_kernel``
  (``matmul_q8_multi_pallas``): 1-3 weights sharing ``x`` in one launch;
* K7 ``q4_gemv`` -- ``_q4_gemv_kernel`` (``matmul_q4_pallas``);
* K8 ``q4_gemv_group`` -- ``_q4_gemv_multi_kernel``
  (``matmul_q4_multi_pallas``);
* K9 ``q4_mlp`` -- ``_q4_mlp_kernel`` (``matmul_q4_mlp_pallas``): the whole
  SwiGLU MLP on three int4 weights in one launch (``csrc/quant_mlp.cu``).

The GEMVs' contract is the Pallas kernels' own: ``y = (x @ q) * s`` with fp32
accumulation and the per-output-column scale applied once after the
accumulation; the output is ``x.dtype``, or fp32 with ``out_fp32``. An
int4 weight is ``quant.pack_int4``'s split-half layout, ``[K, N/2]`` int8
bytes whose low nibble is column ``j`` and high nibble column ``N/2 + j``,
so the output is ordered ``[lo | hi]``. The Pallas kernels round ``x`` to
bf16 before the dot; these read ``x`` in its own dtype (bf16 on the main
path, so the two agree there, and the CPU tests feed bf16-representable
fp32 values).

On a CUDA tensor each wrapper launches the hand-written Hopper kernel in
``csrc/quant_gemv.cu`` or ``csrc/quant_mlp.cu`` (at most ``MAX_ROWS``
rows); on a CPU tensor it
runs the plain version. There is no fallback from one to the other. Not
ported, as TPU-only: the stacked-layer index ``li`` (port layers pass a
contiguous ``[K, N]`` view), the VMEM planners, the lm_head column
splitting and the ``"mask"`` unpack mode.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from .. import kernels

__all__ = [
    "MAX_ROWS", "q8_gemv", "q8_gemv_group", "q4_gemv", "q4_gemv_group",
    "q8_gemv_plain", "q8_gemv_group_plain", "q4_gemv_plain",
    "q4_gemv_group_plain", "unpack_int4", "q4_mlp", "q4_mlp_plain", "GemvPlan",
    "gemv_plan", "MlpPlan", "mlp_plan",
]

MAX_ROWS = 64  # the Pallas kernels' decode row limit (quant_matmul.py:299)
GROUP_SLOTS = 3  # weight slots of the ``*_group`` C entry points (q/k/v)

# the bf16-x kernel's work list (csrc/quant_gemv.cu, gemv_tc_kernel)
ITEM_COLS = 256  # output columns of a column tile
UNIT_BYTES = 32768  # weight bytes of a unit: 128 K rows of an int8 tile, 256 of an int4 one


MAX_SLICES = 16


class GemvPlan(NamedTuple):
    """The work list of one bf16-x GEMV launch, a pure function of the
    shapes and the SM count (``tc_plan`` in ``csrc/quant_gemv.cu``): every
    column tile (``ITEM_COLS`` output columns, counted over the group's
    weights in order) is cut into ``slices`` slices of K, ``chunks`` units
    of ``unit_rows`` K rows each (the last slice may have fewer); cell
    ``slice * tiles + tile`` goes to block ``cell % grid``."""

    tiles: int
    unit_rows: int
    slices: int
    chunks: int
    grid: int
    scratch_bytes: int

    def cell_units(self, cell: int, k: int) -> range:
        """The units (of ``unit_rows`` K rows) of ``cell`` for ``k`` K rows."""
        first = cell // self.tiles * self.chunks
        return range(first, min(first + self.chunks, -(-k // self.unit_rows)))

    def block_cells(self, b: int) -> range:
        """The cells of block ``b``, in the order it walks them."""
        return range(b, self.tiles * self.slices, self.grid)


# what the end of a sliced cell costs in half unit times: the GEMVs' plan and
# K9's (``kSlicedCost`` in ``csrc/quant_mlp.cu``, measured)
GEMV_SLICED_COST, MLP_SLICED_COST = 1, 6


def _split(tiles: int, units: int, sms: int, sliced_cost: int) -> Tuple[int, int]:
    """``(slices, chunks)``: the slices of K that cost the fewest half unit
    times, waves of cells over the SMs times two for each unit of a cell,
    plus ``sliced_cost`` for a cell's partial tile and its share of the sum
    when the tiles are sliced at all (ties: fewer slices); ``tc_plan`` in
    ``csrc/common.cuh``."""
    best = None
    for want in range(1, min(MAX_SLICES, units) + 1):
        chunks = -(-units // want)
        slices = -(-units // chunks)
        cost = -(-tiles * slices // sms) * (2 * chunks + (sliced_cost if slices > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, slices, chunks)
    return best[1], best[2]


def _row_tier(rows: int) -> int:
    """x's rows rounded up to 16, 32 or 64: the rows of a partial tile."""
    return 16 if rows <= 16 else 32 if rows <= 32 else 64


@functools.lru_cache(maxsize=None)  # a decode step asks for the same few plans over and over
def gemv_plan(rows: int, k: int, ns: Tuple[int, ...], int4: bool, sms: int) -> GemvPlan:
    """``GemvPlan`` of ``x [rows, k]`` against weights of ``ns`` output
    columns (a tuple) on a card with ``sms`` SMs (the slices: ``_split``).
    The scratch holds a partial tile a cell, ``rows`` rounded up to 16, 32
    or 64 times ``ITEM_COLS`` floats; an unsliced launch needs none."""
    tiles = sum(-(-n // ITEM_COLS) for n in ns)
    unit_rows = UNIT_BYTES // (ITEM_COLS // 2 if int4 else ITEM_COLS)
    slices, chunks = _split(tiles, -(-k // unit_rows), sms, GEMV_SLICED_COST)
    scratch = 0 if slices == 1 else 4 * tiles * slices * _row_tier(rows) * ITEM_COLS
    return GemvPlan(tiles, unit_rows, slices, chunks, min(sms, tiles * slices), scratch)


def _align256(n: int) -> int:
    return -(-n // 256) * 256


class MlpPlan(NamedTuple):
    """The work lists of one K9 launch (``make_plan`` in
    ``csrc/quant_mlp.cu``), a pure function of the shapes and the SM count.
    ``gate_up`` is phase A: a tile is ``ITEM_COLS`` columns of F in BOTH
    gate and up (128 packed bytes of each weight's rows), a unit
    ``unit_rows`` = 128 K rows; ``down`` is phase B, ``q4_gemv``'s list over
    the down weight (K = F rows, ``ITEM_COLS`` columns of D, units of 256 F
    rows). Both phases run on one persistent block an SM (``grid`` = the
    SMs). Each phase's ``scratch_bytes`` is its partial tiles (phase A: two
    weights' a cell); ``scratch_bytes`` here is ``h`` (``[rows, F]`` bf16)
    and both, each rounded up to 256 bytes. ``tickets``: one a tile of each
    phase."""

    gate_up: GemvPlan
    down: GemvPlan
    scratch_bytes: int
    tickets: int


@functools.lru_cache(maxsize=None)
def mlp_plan(rows: int, k: int, f: int, d: int, sms: int) -> MlpPlan:
    """``MlpPlan`` of ``x [rows, k]`` through an MLP of ``f`` hidden and
    ``d`` output columns on a card with ``sms`` SMs."""
    tile = 4 * _row_tier(rows) * ITEM_COLS  # bytes of one weight's partial tile
    phases = []
    # (tiles, unit rows, K rows, weights a cell): gate and up, then down
    for tiles, unit_rows, kk, weights in ((-(-f // ITEM_COLS), UNIT_BYTES // ITEM_COLS, k, 2),
                                          (-(-d // ITEM_COLS), 2 * UNIT_BYTES // ITEM_COLS, f, 1)):
        slices, chunks = _split(tiles, -(-kk // unit_rows), sms, MLP_SLICED_COST)
        part = 0 if slices == 1 else weights * tile * tiles * slices
        phases.append(GemvPlan(tiles, unit_rows, slices, chunks, sms, part))
    gate_up, down = phases
    scratch = _align256(2 * rows * f) + _align256(gate_up.scratch_bytes) + \
        _align256(down.scratch_bytes)
    return MlpPlan(gate_up, down, scratch, gate_up.tiles + down.tiles)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Split-half nibble pairs -> int8-stored int4 values, last axis
    doubled ``[lo | hi]``; both shifts are arithmetic (sign-extending), and
    the left shift keeps the low 8 bits, as in JAX."""
    return torch.cat([(packed << 4) >> 4, packed >> 4], dim=-1)


def _out_dtype(x: torch.Tensor, out_fp32: bool) -> torch.dtype:
    return torch.float32 if out_fp32 else x.dtype


def _scaled(x: torch.Tensor, w_int: torch.Tensor, s: torch.Tensor,
            out_fp32: bool) -> torch.Tensor:
    """``(x @ w_int) * s`` in fp32, cast once at the end."""
    k = w_int.shape[0]
    acc = x.reshape(-1, k).float() @ w_int.float()
    y = acc * s.reshape(1, -1).float()
    return y.to(_out_dtype(x, out_fp32)).reshape(*x.shape[:-1], w_int.shape[1])


def q8_gemv_plain(x, q, s, out_fp32: bool = False) -> torch.Tensor:
    """Plain version of K5: ``x [..., K]``, ``q`` int8 ``[K, N]``, ``s``
    ``[1, N]`` (or ``[N]``)."""
    return _scaled(x, q, s, out_fp32)


def q4_gemv_plain(x, packed, s, out_fp32: bool = False) -> torch.Tensor:
    """Plain version of K7: ``packed`` int8 ``[K, N/2]`` split-half nibble
    pairs, ``s [1, N]``; output ``[..., N]`` ordered ``[lo | hi]``."""
    return _scaled(x, unpack_int4(packed), s, out_fp32)


def q8_gemv_group_plain(x, qs, ss, out_fp32: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain version of K6: one ``q8_gemv_plain`` per weight."""
    return tuple(q8_gemv_plain(x, q, s, out_fp32) for q, s in zip(qs, ss))


def q4_gemv_group_plain(x, packs, ss, out_fp32: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain version of K8: one ``q4_gemv_plain`` per weight."""
    return tuple(q4_gemv_plain(x, p, s, out_fp32) for p, s in zip(packs, ss))


def _check(what: str, x: torch.Tensor, ws: Sequence[torch.Tensor],
           ss: Sequence[torch.Tensor], int4: bool):
    """Validate what the C entry points cannot see (devices, dtypes, shapes
    and contiguity of the tensors behind the pointers); returns (rows, K,
    Ns). The numeric limits (rows, K, N, alignment) are checked once, by
    ``dispatch`` in ``csrc/quant_gemv.cu``, whose refusal ``kernels.check``
    raises."""
    if not x.is_cuda:
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in kernels.DTYPE_CODES or not x.is_contiguous() or x.dim() < 1:
        raise ValueError(f"{what}: x must be a contiguous float32/bfloat16 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not 1 <= len(ws) <= GROUP_SLOTS or len(ws) != len(ss):
        raise ValueError(f"{what}: need 1-{GROUP_SLOTS} weights with one scale each")
    k = x.shape[-1]
    ns = []
    for w, s in zip(ws, ss):
        if (w.dtype != torch.int8 or w.dim() != 2 or w.shape[0] != k
                or not w.is_contiguous() or w.device != x.device):
            raise ValueError(
                f"{what}: weight must be a contiguous int8 [K={k}, "
                f"{'N/2' if int4 else 'N'}] tensor on {x.device}, got {w.dtype} "
                f"{tuple(w.shape)} on {w.device}")
        cols = w.shape[-1] * (2 if int4 else 1)
        if (s.dtype not in kernels.DTYPE_CODES or s.dtype != ss[0].dtype
                or s.numel() != cols
                or not s.is_contiguous() or s.device != x.device):
            raise ValueError(f"{what}: scales must be contiguous float32/bfloat16 "
                             f"tensors of one dtype, {cols} elements, on {x.device}, got "
                             f"{s.dtype} {tuple(s.shape)} on {s.device}")
        ns.append(cols)
    return (x.numel() // k if k else 0), k, ns


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(what: str, x, ws, ss, out_fp32: bool):
    """Launch C entry point ``what`` (``q8_gemv``, ``q8_gemv_group``,
    ``q4_gemv`` or ``q4_gemv_group``); returns the outputs."""
    rows, k, ns = _check(what, x, ws, ss, int4=what.startswith("q4"))
    out_dtype = _out_dtype(x, out_fp32)
    ys = [torch.empty(*x.shape[:-1], n, dtype=out_dtype, device=x.device) for n in ns]
    dtypes = (kernels.DTYPE_CODES[x.dtype], kernels.DTYPE_CODES[ss[0].dtype],
              kernels.DTYPE_CODES[out_dtype], kernels.stream_of(x))
    scratch = (None, 0, None)  # fp32 x: null pointers
    if x.dtype == torch.bfloat16 and 1 <= rows <= MAX_ROWS and k > 0 and min(ns) > 0:
        plan = gemv_plan(rows, k, tuple(ns), what.startswith("q4"), _sm_count(x.device))
        # from the caching allocator on every call: safe on any stream and
        # under CUDA-graph capture
        if plan.slices > 1:
            buf = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=x.device)
            scratch = (kernels.ptr(buf), plan.scratch_bytes,
                       kernels.ptr(kernels.tickets(x, plan.tiles)))
    if what.endswith("_group"):  # unused slots repeat the first weight, N = 0
        pad = GROUP_SLOTS - len(ws)
        args = [*map(kernels.ptr, list(ws) + [ws[0]] * pad),
                *map(kernels.ptr, list(ss) + [ss[0]] * pad),
                *map(kernels.ptr, ys + [ys[0]] * pad), *scratch, *(ns + [0] * pad),
                len(ws)]
    else:
        args = [kernels.ptr(ws[0]), kernels.ptr(ss[0]), kernels.ptr(ys[0]), *scratch,
                ns[0]]
    code = getattr(kernels.load_library().lib, what)(
        kernels.ptr(x), *args, rows, k, *dtypes)
    kernels.check(code, f"{what} (rows {rows}, K {k}, N {ns}: see the shape "
                        "contract of csrc/quant_gemv.cu)")
    return ys


def q8_gemv(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
            out_fp32: bool = False) -> torch.Tensor:
    """K5: ``(x @ q) * s`` for one int8 weight ``[K, N]``."""
    if x.device.type == "cpu":
        return q8_gemv_plain(x, q, s, out_fp32)
    (y,) = _launch("q8_gemv", x, [q], [s], out_fp32)
    q8_gemv.launches += 1
    return y


def q8_gemv_group(x: torch.Tensor, qs: Sequence[torch.Tensor],
                  ss: Sequence[torch.Tensor], out_fp32: bool = False
                  ) -> Tuple[torch.Tensor, ...]:
    """K6: K5 for 1-3 int8 weights sharing ``x``, in ONE launch."""
    if x.device.type == "cpu":
        return q8_gemv_group_plain(x, qs, ss, out_fp32)
    ys = _launch("q8_gemv_group", x, qs, ss, out_fp32)
    q8_gemv_group.launches += 1
    return tuple(ys)


def q4_gemv(x: torch.Tensor, packed: torch.Tensor, s: torch.Tensor,
            out_fp32: bool = False) -> torch.Tensor:
    """K7: ``(x @ unpack(packed)) * s`` for one split-half int4 weight."""
    if x.device.type == "cpu":
        return q4_gemv_plain(x, packed, s, out_fp32)
    (y,) = _launch("q4_gemv", x, [packed], [s], out_fp32)
    q4_gemv.launches += 1
    return y


def q4_gemv_group(x: torch.Tensor, packs: Sequence[torch.Tensor],
                  ss: Sequence[torch.Tensor], out_fp32: bool = False
                  ) -> Tuple[torch.Tensor, ...]:
    """K8: K7 for 1-3 int4 weights sharing ``x``, in ONE launch."""
    if x.device.type == "cpu":
        return q4_gemv_group_plain(x, packs, ss, out_fp32)
    ys = _launch("q4_gemv_group", x, packs, ss, out_fp32)
    q4_gemv_group.launches += 1
    return tuple(ys)


def q4_mlp_plain(x, gate, up, down, gate_s, up_s, down_s,
                 out_fp32: bool = False) -> torch.Tensor:
    """Plain version of K9, the kernel's arithmetic step by step: ``x`` is
    rounded to bf16 whatever its dtype; ``g = (x @ G) * s_g`` and
    ``u = (x @ U) * s_u`` are summed and scaled in fp32; ``h = silu(g) * u``
    is formed from those fp32 values and rounded to bf16; ``y = (h @ D) *
    s_d`` in fp32, returned in ``x.dtype`` (or fp32). ``gate`` / ``up`` are
    ``[K, F/2]`` and ``down`` ``[F, D/2]`` split-half packed int4; since
    ``[lo | hi]`` is the original column order, ``h`` meets down's rows in
    ffn order."""
    k = gate.shape[0]
    xb = x.reshape(-1, k).to(torch.bfloat16).float()
    g = (xb @ unpack_int4(gate).float()) * gate_s.reshape(1, -1).float()
    u = (xb @ unpack_int4(up).float()) * up_s.reshape(1, -1).float()
    h = (torch.nn.functional.silu(g) * u).to(torch.bfloat16).float()
    y = (h @ unpack_int4(down).float()) * down_s.reshape(1, -1).float()
    return y.to(_out_dtype(x, out_fp32)).reshape(*x.shape[:-1], y.shape[-1])


def q4_mlp(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor, gate_s: torch.Tensor, up_s: torch.Tensor,
           down_s: torch.Tensor, out_fp32: bool = False) -> torch.Tensor:
    """K9: ``silu(x @ gate) * (x @ up) @ down`` on three split-half int4
    weights in ONE launch (``q4_mlp_plain`` states the arithmetic). The
    kernel's scratch (``h`` and the partial tiles of both phases, sized by
    ``mlp_plan``) comes from PyTorch's caching allocator on every call, on
    the current stream, so the call is safe on any stream and under CUDA
    graph capture; its tickets are the device's (``kernels.tickets``)."""
    if x.device.type == "cpu":
        return q4_mlp_plain(x, gate, up, down, gate_s, up_s, down_s, out_fp32)
    rows, k, (f, d) = _check_mlp(x, gate, up, down, gate_s, up_s, down_s)
    out_dtype = _out_dtype(x, out_fp32)
    codes = (kernels.DTYPE_CODES[x.dtype], kernels.DTYPE_CODES[gate_s.dtype],
             kernels.DTYPE_CODES[out_dtype])
    plan = mlp_plan(rows, k, f, d, _sm_count(x.device))
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=x.device)
    y = torch.empty(*x.shape[:-1], d, dtype=out_dtype, device=x.device)
    code = kernels.load_library().lib.q4_mlp(
        kernels.ptr(x), kernels.ptr(gate), kernels.ptr(up), kernels.ptr(down),
        kernels.ptr(gate_s), kernels.ptr(up_s), kernels.ptr(down_s), kernels.ptr(y),
        kernels.ptr(scratch), plan.scratch_bytes, kernels.ptr(kernels.tickets(x, plan.tickets)),
        rows, k, f, d, *codes, kernels.stream_of(x))
    kernels.check(code, f"q4_mlp (rows {rows}, K {k}, F {f}, D {d}: see the shape contract "
                        "of csrc/quant_mlp.cu)")
    q4_mlp.launches += 1
    return y


def _check_mlp(x, gate, up, down, gate_s, up_s, down_s):
    """What ``q4_mlp``'s C entry point cannot see; returns (rows, K, (F, D))."""
    if not x.is_cuda:
        raise ValueError(f"q4_mlp: unsupported device {x.device}")
    if x.dtype not in kernels.DTYPE_CODES or not x.is_contiguous() or x.dim() < 1:
        raise ValueError(f"q4_mlp: x must be a contiguous float32/bfloat16 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    k = x.shape[-1]
    half_f, half_d = gate.shape[-1], down.shape[-1]
    for name, w, shape in (("gate", gate, (k, half_f)), ("up", up, (k, half_f)),
                           ("down", down, (2 * half_f, half_d))):
        if (w.dtype != torch.int8 or tuple(w.shape) != shape or not w.is_contiguous()
                or w.device != x.device):
            raise ValueError(f"q4_mlp: {name} must be a contiguous int8 {shape} tensor "
                             f"on {x.device}, got {w.dtype} {tuple(w.shape)} on {w.device}")
    for name, s, n in (("gate_s", gate_s, 2 * half_f), ("up_s", up_s, 2 * half_f),
                       ("down_s", down_s, 2 * half_d)):
        if (s.dtype not in kernels.DTYPE_CODES or s.dtype != gate_s.dtype
                or s.numel() != n or not s.is_contiguous() or s.device != x.device):
            raise ValueError(f"q4_mlp: {name} must be a contiguous float32/bfloat16 "
                             f"tensor (one dtype for all three) of {n} elements on "
                             f"{x.device}, got {s.dtype} {tuple(s.shape)} on {s.device}")
    return (x.numel() // k if k else 0), k, (2 * half_f, 2 * half_d)


for _fn in (q8_gemv, q8_gemv_group, q4_gemv, q4_gemv_group, q4_mlp):
    _fn.launches = 0
