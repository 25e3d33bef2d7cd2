"""Static-shape KV cache (counterpart of ``dynamic_llava_tpu/ops/kv_cache.py``).

A preallocated ``[L, B, max_len, Hkv, d]`` buffer per tier with int32
``[L, B]`` lengths. Decode protocol: every layer attends over
``[0, length)`` plus the current token appended virtually, all layers'
K/V are then written at slot ``length``, and ``advance_tiered`` persists
the token by raising the length (the pre tier always, the post tier only
for a kept token) -- a dropped token's slot is overwritten next step.

Storage dtypes: bf16 (default) or fp32; ``torch.float8_e4m3fn`` (a plain
cast on write and on read); or scaled int8 (``torch.int8``): each written
K/V head vector is quantized with one bf16 scale per (layer, sample, slot,
head), kept in the side buffers ``k_scale`` / ``v_scale`` and folded into
the attention on read (``ops.attention.decode_attend_appended``).
The continuation prefill writes a whole chunk's K/V at once
(``write_chunk_layers``), compacted to the kept tokens. Continuous batching
admits a request by ``splice_tiered_slot``: one row of a batched admission
cache copied into one slot of the engine's cache, in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import LlamaConfig

STORAGE_DTYPES = (torch.bfloat16, torch.float32, torch.int8, torch.float8_e4m3fn)


class KVCache(NamedTuple):
    """Cache for a contiguous range of layers (layer axis range-relative).
    ``k_scale`` / ``v_scale`` exist only in the scaled-int8 mode."""

    k: torch.Tensor  # [L, B, max_len, Hkv, d]
    v: torch.Tensor  # [L, B, max_len, Hkv, d]
    length: torch.Tensor  # [L, B] int32 persisted tokens per layer/sample
    k_scale: Optional[torch.Tensor] = None  # [L, B, max_len, Hkv] bf16
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


class TieredCache(NamedTuple):
    """``pre``: layers [0, sparse_layer) at full length; ``post``: layers
    [sparse_layer, L) allocated at the pruned budget."""

    pre: KVCache
    post: KVCache


def quantize_kv(x: torch.Tensor):
    """``[..., d] -> (int8 [..., d], bf16 scale [...])``: symmetric
    per-vector quantization. The scale is ``max(amax, 1e-8) * (1/127)``
    rounded to bf16, and the division uses that ROUNDED scale (what the
    reader multiplies by); ``torch.round`` rounds half to even like
    ``jnp.round``. The fp32 ``1/127`` is made by a fill on ``x``'s device,
    not copied from the host, so a decode step captures into a CUDA graph."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    inv = torch.full((), 1.0 / 127.0, dtype=torch.float32, device=x.device)
    scale = (torch.clamp(amax, min=1e-8) * inv).to(torch.bfloat16)
    q = torch.clamp(torch.round(xf / scale.float()[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return q.to(dtype) * scale[..., None].to(dtype)


def to_storage(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in the cache's (non-int8) storage dtype. The fp8 cast is the
    XLA ``astype``: round to nearest even, and NaN for what rounds past
    +-448 (|x| > 464, infinities included). PyTorch's own cast saturates
    those to +-448 instead, so they are set to NaN here."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    y = x.to(dtype).view(torch.uint8)
    # a saturated byte is 0x7E / 0xFE; the NaN of its sign is 0x7F / 0xFF
    return torch.where(x.abs() > 464.0, y | 1, y).view(dtype)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A one-byte tensor as uint8: fp8 tensors have no indexed assignment
    (``index_put_``) kernel, their bytes do."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def init_cache(
    cfg: LlamaConfig,
    batch: int,
    max_len: int,
    dtype=torch.bfloat16,
    num_layers: Optional[int] = None,
    device=None,
) -> KVCache:
    n = cfg.num_hidden_layers if num_layers is None else num_layers
    shape = (n, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    if dtype not in STORAGE_DTYPES:
        raise ValueError(f"KV storage dtype {dtype} is not one of {STORAGE_DTYPES}")

    def zeros(shape, dt):  # fp8 has no fill kernel on every backend: zero bytes
        if dt == torch.float8_e4m3fn:
            return torch.zeros(shape, dtype=torch.uint8, device=device).view(dt)
        return torch.zeros(shape, dtype=dt, device=device)

    scales = dtype == torch.int8
    return KVCache(
        k=zeros(shape, dtype),
        v=zeros(shape, dtype),
        length=torch.zeros((n, batch), dtype=torch.int32, device=device),
        k_scale=zeros(shape[:-1], torch.bfloat16) if scales else None,
        v_scale=zeros(shape[:-1], torch.bfloat16) if scales else None,
    )


def init_tiered_cache(
    cfg: LlamaConfig,
    sparse_layer: int,
    batch: int,
    max_len_pre: int,
    max_len_post: int,
    dtype=torch.bfloat16,
    device=None,
) -> TieredCache:
    return TieredCache(
        pre=init_cache(cfg, batch, max_len_pre, dtype, sparse_layer, device),
        post=init_cache(
            cfg, batch, max_len_post, dtype,
            cfg.num_hidden_layers - sparse_layer, device,
        ),
    )


def write_prefill(cache: KVCache, li: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write layer ``li``'s prefill K/V ``[B, S, Hkv, d]`` at slots
    ``[0, S)`` IN PLACE, quantized (with their scales) or cast to the
    storage dtype."""
    s = k.shape[1]
    if cache.quantized:
        qk, ksc = quantize_kv(k)
        qv, vsc = quantize_kv(v)
        cache.k[li, :, :s] = qk
        cache.v[li, :, :s] = qv
        cache.k_scale[li, :, :s] = ksc
        cache.v_scale[li, :, :s] = vsc
        return
    _bytes(cache.k)[li, :, :s] = _bytes(to_storage(k, cache.k.dtype))
    _bytes(cache.v)[li, :, :s] = _bytes(to_storage(v, cache.v.dtype))


def write_token_layers(
    k: torch.Tensor,  # [L, B, max_len, Hkv, d]
    v: torch.Tensor,
    k_new: torch.Tensor,  # [L, B, 1, Hkv, d] per-layer current-token K
    v_new: torch.Tensor,
    length: torch.Tensor,  # [L, B] write slot per layer/sample (tier-uniform)
) -> None:
    """Write every layer's current token at slot ``length[0, b]``.

    IN PLACE: the JAX version rebuilds the buffers (one
    ``dynamic_update_slice`` per sample); here one indexed copy per buffer
    writes the ``L x B`` head vectors into the existing storage. Within a
    tier all layers share one slot, so ``length[0]`` is every layer's.
    ``k_new`` / ``v_new`` are cast to the storage dtype (already-quantized
    int8 values pass through)."""
    pos = length[0].long()  # [B]
    bidx = torch.arange(k.shape[1], device=k.device)
    _bytes(k)[:, bidx, pos] = _bytes(to_storage(k_new[:, :, 0], k.dtype))
    _bytes(v)[:, bidx, pos] = _bytes(to_storage(v_new[:, :, 0], v.dtype))


def write_token_scales(
    k_scale: torch.Tensor,  # [L, B, max_len, Hkv]
    v_scale: torch.Tensor,
    ks_new: torch.Tensor,  # [L, B, 1, Hkv] per-layer current-token K scales
    vs_new: torch.Tensor,
    length: torch.Tensor,  # [L, B]
) -> None:
    """Scale-buffer companion of ``write_token_layers`` (scaled-int8 mode),
    IN PLACE."""
    pos = length[0].long()
    bidx = torch.arange(k_scale.shape[1], device=k_scale.device)
    k_scale[:, bidx, pos] = ks_new[:, :, 0].to(k_scale.dtype)
    v_scale[:, bidx, pos] = vs_new[:, :, 0].to(v_scale.dtype)


def write_chunk_layers(
    cache: KVCache,
    k_new: torch.Tensor,  # [L, B, M, Hkv, d] every layer's chunk K (unrounded)
    v_new: torch.Tensor,
    target: torch.Tensor,  # [B, M] int32 slot per chunk token
) -> None:
    """Write every layer's chunk K/V at ``target`` IN PLACE: kept tokens at
    their compacted slots, dropped ones at the scratch slot ``max_len - 1``
    (several dropped tokens land there, in no fixed order on the card;
    nothing reads that slot). Quantized to int8 with their scales, or cast
    to the storage dtype (fp8 through the bytes), as ``write_token_layers``
    / ``write_token_scales`` do for one token."""
    bidx = torch.arange(target.shape[0], device=target.device)[:, None]
    tgt = target.long()
    if cache.quantized:
        qk, ksc = quantize_kv(k_new)
        qv, vsc = quantize_kv(v_new)
        cache.k[:, bidx, tgt] = qk
        cache.v[:, bidx, tgt] = qv
        cache.k_scale[:, bidx, tgt] = ksc
        cache.v_scale[:, bidx, tgt] = vsc
        return
    _bytes(cache.k)[:, bidx, tgt] = _bytes(to_storage(k_new, cache.k.dtype))
    _bytes(cache.v)[:, bidx, tgt] = _bytes(to_storage(v_new, cache.v.dtype))


def advance_tiered(cache: TieredCache, keep: torch.Tensor,
                   active: Optional[torch.Tensor] = None) -> TieredCache:
    """The pre tier always persists the token; the post tier persists it
    iff ``keep`` [B] (a dropped token's slot is overwritten next step).
    ``active`` [B] bool gates the whole advance per sample: an inactive
    sample persists nothing in either tier (callers also gate ``keep``)."""
    pre_inc = 1 if active is None else active.to(torch.int32)[None, :]
    pre = cache.pre._replace(length=cache.pre.length + pre_inc)
    post = cache.post._replace(
        length=cache.post.length + keep.to(torch.int32)[None, :]
    )
    return TieredCache(pre=pre, post=post)


def splice_cache_slot(dst: KVCache, src: KVCache, slot: int, row: int = 0) -> None:
    """Copy row ``row`` of ``src`` into batch slot ``slot`` of ``dst`` IN
    PLACE: K/V, the int8 scales and the lengths (the JAX function takes a
    batch-1 source and returns a new cache). The admission primitive of
    continuous batching (``generation.continuous``): a freshly prefilled
    request replaces whatever a retired one left in the slot.

    ``src`` may hold fewer slots than ``dst`` (an admission cache holds only
    the prompt): only ``[:src.max_len]`` is copied, and the slots past it
    keep the retired request's K/V, which nothing reads (attention reads
    ``[0, length)``). fp8 tensors are copied through their bytes."""
    if src.num_layers != dst.num_layers or src.max_len > dst.max_len:
        raise ValueError(f"splice_cache_slot: a source of {src.num_layers} layers x "
                         f"{src.max_len} slots does not fit {dst.num_layers} x {dst.max_len}")
    if src.k.dtype != dst.k.dtype or src.quantized != dst.quantized:
        raise ValueError(f"splice_cache_slot: storage {src.k.dtype} into {dst.k.dtype}")
    n = src.max_len
    pairs = [(dst.k, src.k), (dst.v, src.v)]
    if dst.quantized:
        pairs += [(dst.k_scale, src.k_scale), (dst.v_scale, src.v_scale)]
    for d, s in pairs:
        _bytes(d)[:, slot, :n].copy_(_bytes(s)[:, row])
    dst.length[:, slot].copy_(src.length[:, row])


def splice_tiered_slot(dst: TieredCache, src: TieredCache, slot: int, row: int = 0) -> None:
    """``splice_cache_slot`` of both tiers."""
    splice_cache_slot(dst.pre, src.pre, slot, row)
    splice_cache_slot(dst.post, src.post, slot, row)
