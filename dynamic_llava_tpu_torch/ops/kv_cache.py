"""Static-shape KV cache (counterpart of ``dynamic_llava_tpu/ops/kv_cache.py``).

A preallocated ``[L, B, max_len, Hkv, d]`` buffer per tier with int32
``[L, B]`` lengths. Decode protocol: every layer attends over
``[0, length)`` plus the current token appended virtually, all layers'
K/V are then written at slot ``length``, and ``advance_tiered`` persists
the token by raising the length (the pre tier always, the post tier only
for a kept token) -- a dropped token's slot is overwritten next step.

Storage here is bf16 (or the activations' dtype); the int8 and fp8 modes
of the JAX package are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import LlamaConfig


class KVCache(NamedTuple):
    """Cache for a contiguous range of layers (layer axis range-relative)."""

    k: torch.Tensor  # [L, B, max_len, Hkv, d]
    v: torch.Tensor  # [L, B, max_len, Hkv, d]
    length: torch.Tensor  # [L, B] int32 persisted tokens per layer/sample

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]


class TieredCache(NamedTuple):
    """``pre``: layers [0, sparse_layer) at full length; ``post``: layers
    [sparse_layer, L) allocated at the pruned budget."""

    pre: KVCache
    post: KVCache


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
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"KV storage dtype {dtype} is not supported yet")
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((n, batch), dtype=torch.int32, device=device),
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
    tier all layers share one length, so ``length[0]`` is every layer's
    slot."""
    pos = length[0].long()  # [B]
    bidx = torch.arange(k.shape[1], device=k.device)
    k[:, bidx, pos] = k_new[:, :, 0].to(k.dtype)
    v[:, bidx, pos] = v_new[:, :, 0].to(v.dtype)


def advance_tiered(cache: TieredCache, keep: torch.Tensor) -> TieredCache:
    """The pre tier always persists the token; the post tier persists it
    iff ``keep`` [B] (a dropped token's slot is overwritten next step)."""
    pre = cache.pre._replace(length=cache.pre.length + 1)
    post = cache.post._replace(
        length=cache.post.length + keep.to(torch.int32)[None, :]
    )
    return TieredCache(pre=pre, post=post)
