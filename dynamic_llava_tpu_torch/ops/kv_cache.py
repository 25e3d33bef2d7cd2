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
``splice_cache_slot`` (continuous batching) is not ported yet.
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
