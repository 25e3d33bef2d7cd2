"""Decode attention: kernel K2, its M-query form, and their plain PyTorch
versions.

Counterpart of ``dynamic_llava_tpu/ops/decode_attention.py``
(``flash_decode_attention`` over the Pallas ``_decode_kernel``), ported to
the contract the decode layer loop calls, ``decode_attend_appended``: the
current token's K/V are appended virtually to the persisted cache rows
``[0, length)``, the cache stored in bf16, fp32, fp8 or scaled int8, with
an optional sliding window. ``extend_attention`` is the same for a chunk of
M tokens a sample (the continuation prefill's ``extend_attend_appended``,
an XLA function in the JAX package): the chunk's own K/V are M more
columns, causal inside the chunk. On a CUDA tensor both launch a
hand-written Hopper kernel, which reads only the live rows and splits them
over ``decode_split`` blocks per (kv head, sample, tile of query rows),
merged inside the same launch: ``decode_kernel`` in
``csrc/decode_attention.cu``; for M tokens ``extend_mma_kernel``
(``csrc/extend_attention.cu``, tensor cores, tiles of 64 query rows) with a
bf16 q over a bf16, int8 or fp8 cache, else ``extend_kernel`` (CUDA cores,
groups of 8 query rows), as ``extend_plan`` says. On a CPU tensor they run
the plain versions (``ops.attention.decode_attend_appended`` /
``extend_attend_appended``). There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from .attention import decode_attend_appended as decode_attention_plain
from .attention import extend_attend_appended as extend_attention_plain
from .attention import sliding_window_mask

__all__ = ["decode_attention", "decode_attention_plain", "decode_split", "extend_attention",
           "extend_attention_plain", "extend_mask", "extend_plan"]


# storage codes of the cache (csrc/common.cuh DType): q's own codes plus the
# one-byte modes
STORAGE_CODES = {**kernels.DTYPE_CODES, torch.int8: 2, torch.float8_e4m3fn: 3}


# the split of the cache length over blocks (flash-decoding)
SPLIT_TARGET_BLOCKS = 128  # about a block an SM: more splits bought nothing on the H100
# the same for the tensor-core M-query form, whose blocks are heavier: on the
# H100 192 beat 128 and 264 at the chat and verify shapes (the split merge,
# done by one block a kv head, grows with the splits)
MMA_SPLIT_TARGET_BLOCKS = 192
SPLIT_MIN_ROWS = 64  # cache rows a block owns at least
MAX_SPLIT = 32  # kMaxSplit of csrc/decode_attention.cu
MAX_Q = 8  # kMaxQ of csrc/decode_attention.cu: query rows of a CUDA-core block
MMA_ROWS = 64  # kBR of csrc/extend_attention.cu: query rows of a tensor-core block


def decode_split(b: int, hkv: int, max_len: int, target: Optional[int] = None) -> int:
    """Blocks that share the cache rows of one (kv head, sample): enough for
    ``target`` (``SPLIT_TARGET_BLOCKS``) blocks a call, each owning at least
    ``SPLIT_MIN_ROWS`` rows of the capacity. A function of the shapes alone
    (the lengths live on the device), so every call with the same shapes
    sums in the same order."""
    want = -(-(target or SPLIT_TARGET_BLOCKS) // max(1, b * hkv))
    return max(1, min(want, max_len // SPLIT_MIN_ROWS, MAX_SPLIT))


class ExtendPlan(NamedTuple):
    """How a call of the M-query form is cut, from the shapes alone."""

    tensor_cores: bool  # extend_mma_kernel (else extend_kernel)
    block_rows: int  # query rows of a kv head a block takes at most
    row_tiles: int  # blocks a (kv head, sample, split)
    n_split: int  # blocks that share a (kv head, sample, row tile)'s cache rows
    workspace_bytes: int  # fp32 partial states (0 at n_split 1)
    tickets: int  # int32 tickets (0 at n_split 1)


def extend_plan(b: int, m: int, h: int, hkv: int, d: int, max_len: int,
                q_dtype: torch.dtype, store: torch.dtype) -> ExtendPlan:
    """The kernel, row tiles, split, workspace and tickets of an
    ``extend_attention`` call, mirroring the C entry
    (``extend_attention_workspace_bytes``): a bf16 q over a bf16, int8 or
    fp8 cache runs on the tensor cores in tiles of ``MMA_ROWS`` query rows of
    a kv head (row r = chunk token r // n_rep, head r % n_rep), anything
    else on the CUDA cores in groups of ``MAX_Q``; the cache length is split
    by ``decode_split`` over (row tile, sample) pairs. The workspace holds
    (acc [rows, d], m, l) of every (sample, kv head, row tile, split), rows
    = the smaller of a tile and a kv head's M x n_rep."""
    tc = q_dtype == torch.bfloat16 and store != torch.float32
    per = MMA_ROWS if tc else MAX_Q
    rows = m * (h // hkv)
    tiles = -(-rows // per)
    n_split = decode_split(b * tiles, hkv, max_len, MMA_SPLIT_TARGET_BLOCKS if tc else None)
    if n_split == 1:
        return ExtendPlan(tc, per, tiles, 1, 0, 0)
    # a row's acc and (m, l): d + 2 floats, padded to d + 4 on the tensor
    # cores for 16-byte rows
    ws = 4 * b * hkv * tiles * n_split * min(rows, per) * (d + (4 if tc else 2))
    return ExtendPlan(tc, per, tiles, n_split, ws, b * hkv * tiles)


def _need(fn: str, q: torch.Tensor, name: str, t, dtype, shape, align: int = 16) -> None:
    """Raise unless ``t`` is a contiguous, ``align``-byte aligned ``dtype``
    tensor of ``shape`` on q's device. (16-byte alignment holds for every
    layer view of a stacked buffer, a layer being a multiple of 64 bytes,
    and is checked all the same; int32 vectors, such as a layer's row of the
    lengths, need only their own alignment.)"""
    if (t is None or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != q.device or t.data_ptr() % align):
        raise ValueError(
            f"{fn}: {name} must be a contiguous, {align}-byte aligned {dtype} tensor of "
            f"shape {tuple(shape)} on {q.device}, got "
            f"{None if t is None else (tuple(t.shape), t.dtype, t.device)}"
        )


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, d]
    k_cache: torch.Tensor,  # [B, max_len, Hkv, d]
    v_cache: torch.Tensor,  # [B, max_len, Hkv, d]
    k_cur: torch.Tensor,  # [B, 1, Hkv, d]
    v_cur: torch.Tensor,  # [B, 1, Hkv, d]
    length: torch.Tensor,  # [B] int32 attend bound (the persisted length)
    *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    q_pos: Optional[torch.Tensor] = None,  # [B] int32, with ``window``
    k_scale: Optional[torch.Tensor] = None,  # [B, max_len, Hkv] bf16, int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token attention over ``cache[:length] ++ current``; returns
    ``[B, 1, H, d]`` in q's dtype. The cache is stored in bf16, fp32, fp8
    (``float8_e4m3fn``) or int8 with per-vector ``k_scale`` / ``v_scale``
    (folded into scores and probabilities, never dequantized); ``length``
    is the attend bound (the ring policy passes ``min(length, budget)``);
    with ``window`` only columns ``j`` with ``q_pos - j < window`` are
    visible (and read)."""
    store = k_cache.dtype
    if (store == torch.int8) != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention: k_scale and v_scale go with an int8 "
                         "cache, both or neither")
    if window is not None and (q_pos is None or window < 1):
        raise ValueError(f"decode_attention: window {window} must be >= 1 and come "
                         "with q_pos")
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, k_cur, v_cur, length, scale=scale,
            window=window, q_pos=q_pos, k_scale=k_scale, v_scale=v_scale,
        )
    if not q.is_cuda:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, one, h, d = q.shape
    _, max_len, hkv, _ = k_cache.shape
    if q.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"decode_attention: unsupported dtype {q.dtype}")
    if one != 1 or d not in (64, 128) or hkv == 0 or h % hkv or h // hkv > 8:
        raise ValueError(
            f"decode_attention: need q [B, 1, H, d] with d in (64, 128) and "
            f"H a multiple of Hkv with H/Hkv <= 8, got q {tuple(q.shape)} "
            f"cache {tuple(k_cache.shape)}"
        )
    if store not in STORAGE_CODES:
        raise ValueError(f"decode_attention: unsupported cache dtype {store}")

    _need("decode_attention", q, "q", q, q.dtype, (b, 1, h, d))
    _need("decode_attention", q, "k_cache", k_cache, store, (b, max_len, hkv, d))
    _need("decode_attention", q, "v_cache", v_cache, store, (b, max_len, hkv, d))
    _need("decode_attention", q, "k_cur", k_cur, q.dtype, (b, 1, hkv, d))
    _need("decode_attention", q, "v_cur", v_cur, q.dtype, (b, 1, hkv, d))
    if k_scale is not None:
        _need("decode_attention", q, "k_scale", k_scale, torch.bfloat16, (b, max_len, hkv))
        _need("decode_attention", q, "v_scale", v_scale, torch.bfloat16, (b, max_len, hkv))
    _need("decode_attention", q, "length", length, torch.int32, (b,), align=4)
    if window is not None:
        _need("decode_attention", q, "q_pos", q_pos, torch.int32, (b,), align=4)
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    lib = kernels.load_library().lib
    n_split = decode_split(b, hkv, max_len)
    workspace = tickets = None  # None: a null pointer
    nbytes = lib.decode_attention_workspace_bytes(b, 1, h, hkv, d, n_split)
    if n_split > 1:
        # from the caching allocator on every call: safe on any stream and
        # under CUDA-graph capture
        workspace = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
        tickets = kernels.tickets(q, b * hkv)
    code = lib.decode_attention_appended(
        kernels.ptr(q), kernels.ptr(k_cache), kernels.ptr(v_cache),
        kernels.ptr(k_cur), kernels.ptr(v_cur), kernels.ptr(length),
        None if k_scale is None else kernels.ptr(k_scale),  # None: a null pointer
        None if v_scale is None else kernels.ptr(v_scale),
        None if window is None else kernels.ptr(q_pos),
        kernels.ptr(out),
        None if workspace is None else kernels.ptr(workspace), nbytes,
        None if tickets is None else kernels.ptr(tickets), n_split,
        b, max_len, h, hkv, d, float(scale),
        0 if window is None else int(window),
        kernels.DTYPE_CODES[q.dtype], STORAGE_CODES[store], kernels.stream_of(q),
    )
    kernels.check(code, "decode_attention_appended")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def extend_mask(
    length: torch.Tensor,  # [B] int32 persisted bound (clamped to max_len)
    max_len: int,
    m: int,
    *,
    chunk_attend: Optional[torch.Tensor] = None,  # [B, M] bool
    window: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,  # [B, M] int32, with ``window``
) -> torch.Tensor:
    """The ``[B, 1, M, max_len + M]`` bool mask of the continuation prefill,
    built as the JAX ``run_layers_extend`` builds it: cache columns below
    ``min(length, max_len)``; chunk column ``i`` visible to row ``j`` iff
    ``i <= j`` and, with ``chunk_attend``, ``i == j or chunk_attend[b, i]``;
    with ``window``, cache column ``c`` (slot = position in a dense cache)
    iff ``positions[b, j] - c < window`` and chunk column ``i`` iff
    ``positions[b, j] - positions[b, i] < window``."""
    b = length.shape[0]
    dev = length.device
    cache_cols = torch.arange(max_len, dtype=torch.int32, device=dev)
    cache_mask = cache_cols[None, :] < torch.clamp(length, max=max_len)[:, None]
    rows = torch.arange(m, dtype=torch.int32, device=dev)
    chunk_mask = (rows[None, :, None] >= rows[None, None, :]).expand(b, m, m)
    if chunk_attend is not None:
        self_cols = rows[None, :, None] == rows[None, None, :]
        chunk_mask = chunk_mask & (chunk_attend[:, None, :] | self_cols)
    mask = torch.cat([cache_mask[:, None, None, :].expand(b, 1, m, max_len),
                      chunk_mask[:, None]], dim=-1)
    if window is not None:
        mask = mask & torch.cat([sliding_window_mask(positions, cache_cols, window),
                                 sliding_window_mask(positions, positions, window)], dim=-1)
    return mask


def extend_attention(
    q: torch.Tensor,  # [B, M, H, d] chunk queries
    k_cache: torch.Tensor,  # [B, max_len, Hkv, d]
    v_cache: torch.Tensor,  # [B, max_len, Hkv, d]
    k_chunk: torch.Tensor,  # [B, M, Hkv, d] the chunk's own K/V, in q's dtype
    v_chunk: torch.Tensor,  # [B, M, Hkv, d]
    length: torch.Tensor,  # [B] int32 persisted bound (clamped to max_len)
    *,
    chunk_attend: Optional[torch.Tensor] = None,  # [B, M] bool
    window: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,  # [B, M] int32, with ``window``
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # [B, max_len, Hkv] bf16, int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """M chunk queries a sample over ``cache[:length] ++ chunk``, causal
    inside the chunk (the mask of ``extend_mask``); returns ``[B, M, H, d]``
    in q's dtype. Storage as ``decode_attention``. Every row sees at least
    its own column, so padding rows of a ragged chunk come out finite."""
    store = k_cache.dtype
    if (store == torch.int8) != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("extend_attention: k_scale and v_scale go with an int8 "
                         "cache, both or neither")
    if window is not None and (positions is None or window < 1):
        raise ValueError(f"extend_attention: window {window} must be >= 1 and come "
                         "with positions")
    if q.device.type == "cpu":
        mask = extend_mask(length, k_cache.shape[1], q.shape[1], chunk_attend=chunk_attend,
                           window=window, positions=positions)
        return extend_attention_plain(q, k_cache, v_cache, k_chunk, v_chunk, mask,
                                      scale=scale, k_scale=k_scale, v_scale=v_scale)
    if not q.is_cuda:
        raise ValueError(f"extend_attention: unsupported device {q.device}")
    b, m, h, d = q.shape
    _, max_len, hkv, _ = k_cache.shape
    if q.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"extend_attention: unsupported dtype {q.dtype}")
    if m < 1 or d not in (64, 128) or hkv == 0 or h % hkv or h // hkv > 8:
        raise ValueError(
            f"extend_attention: need q [B, M, H, d] with M >= 1, d in (64, 128) and "
            f"H a multiple of Hkv with H/Hkv <= 8, got q {tuple(q.shape)} "
            f"cache {tuple(k_cache.shape)}"
        )
    if store not in STORAGE_CODES:
        raise ValueError(f"extend_attention: unsupported cache dtype {store}")
    fn = "extend_attention"
    _need(fn, q, "q", q, q.dtype, (b, m, h, d))
    _need(fn, q, "k_cache", k_cache, store, (b, max_len, hkv, d))
    _need(fn, q, "v_cache", v_cache, store, (b, max_len, hkv, d))
    _need(fn, q, "k_chunk", k_chunk, q.dtype, (b, m, hkv, d))
    _need(fn, q, "v_chunk", v_chunk, q.dtype, (b, m, hkv, d))
    if k_scale is not None:
        _need(fn, q, "k_scale", k_scale, torch.bfloat16, (b, max_len, hkv))
        _need(fn, q, "v_scale", v_scale, torch.bfloat16, (b, max_len, hkv))
    _need(fn, q, "length", length, torch.int32, (b,), align=4)
    if window is not None:
        _need(fn, q, "positions", positions, torch.int32, (b, m), align=4)
    if chunk_attend is not None:
        _need(fn, q, "chunk_attend", chunk_attend, torch.bool, (b, m), align=1)
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    lib = kernels.load_library().lib
    plan = extend_plan(b, m, h, hkv, d, max_len, q.dtype, store)
    workspace = tickets = None  # None: a null pointer
    if plan.n_split > 1:
        # from the caching allocator on every call: safe on any stream and
        # under CUDA-graph capture
        workspace = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=q.device)
        tickets = kernels.tickets(q, plan.tickets)
    code = lib.extend_attention_appended(
        kernels.ptr(q), kernels.ptr(k_cache), kernels.ptr(v_cache),
        kernels.ptr(k_chunk), kernels.ptr(v_chunk), kernels.ptr(length),
        None if k_scale is None else kernels.ptr(k_scale),  # None: a null pointer
        None if v_scale is None else kernels.ptr(v_scale),
        None if window is None else kernels.ptr(positions),
        None if chunk_attend is None else kernels.ptr(chunk_attend),
        kernels.ptr(out),
        None if workspace is None else kernels.ptr(workspace), plan.workspace_bytes,
        None if tickets is None else kernels.ptr(tickets), plan.n_split,
        b, m, max_len, h, hkv, d, float(scale),
        0 if window is None else int(window),
        kernels.DTYPE_CODES[q.dtype], STORAGE_CODES[store], kernels.stream_of(q),
    )
    kernels.check(code, "extend_attention_appended")
    extend_attention.launches += 1
    return out


extend_attention.launches = 0
