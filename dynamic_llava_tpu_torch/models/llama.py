"""LLaMA decoder (counterpart of ``dynamic_llava_tpu/models/llama.py``),
with bf16/fp32 or weight-only int8/int4 linears and optional LoRA adapters.

Params are the JAX pytree with torch tensors: layer weights stacked along
a leading ``[L, ...]`` axis, linears stored ``[in, out]`` (forward
``x @ W``). Python loops over layers replace ``lax.scan``; ``layers[name][i]``
is a view, so no weights are copied. A quantized weight is a dict leaf
(``ops.quant``) and every linear goes through ``ops.quant.linear`` /
``linear_group``, which also add a LoRA adapter's delta where a
``{name}_lora`` leaf ``{"a": [L, in, r], "b": [L, r, out], "s": 0-d}`` is
attached (``train.lora``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..config import LlamaConfig
from ..ops.attention import (
    attend, attend_with_policy, make_attention_mask, self_attend, sliding_window_mask)
from ..ops.decode_attention import decode_attention, extend_attention
from ..ops import flash_policy  # noqa: F401  (registers the F2 dispatcher ops)
from ..ops.kv_cache import (
    KVCache, quantize_kv, write_chunk_layers, write_prefill, write_token_layers,
    write_token_scales)
from ..ops.norm import rms_norm
from ..ops.quant import (
    dequantize_weight, is_quantized, linear, linear_group, matmul, matmul_q4_mlp,
    unpack_int4)
from ..ops.rope import apply_rope_for_config


def _layer_leaf(w, i: int):
    if isinstance(w, dict):  # quantized {"q"|"q4", "s"} or LoRA {"a", "b", "s"}
        # a LoRA scale is one 0-d tensor for all layers
        return {k: t if not is_quantized(w) and k == "s" else t[i] for k, t in w.items()}
    return w[i]


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s weights as views into the stacked tensors; a quantized
    leaf gives ``{"q"|"q4": w[i], "s": s[i]}``, a LoRA adapter
    ``{"a": a[i], "b": b[i], "s": s}``. A leaf may also be a list of
    per-layer tensors (the trainer's gradient-carrying views)."""
    return {name: _layer_leaf(w, i) for name, w in layers.items()}


def embed_tokens(params, ids: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    if is_quantized(emb):  # gather the rows, unpack int4, then scale
        ids = ids.long()
        scale = emb["s"][ids]
        q = unpack_int4(emb["q4"][ids]) if "q4" in emb else emb["q"][ids]
        return q.to(scale.dtype) * scale
    return F.embedding(ids.long(), emb)


def lm_head(params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm + vocabulary projection; fp32 logits, accumulated in fp32
    (the JAX ``preferred_element_type=float32``). An untied quantized head
    goes through the GEMVs; a tied quantized embedding is dequantized."""
    x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
    if not cfg.tie_word_embeddings:
        return linear(params, "lm_head", x, out_fp32=True)
    return matmul(x, dequantize_weight(params["embed"], x.dtype).T, out_fp32=True)


def _qkv(lp, cfg: LlamaConfig, h: torch.Tensor, positions: torch.Tensor):
    b, s, _ = h.shape
    q, k, v = linear_group(lp, ("q", "k", "v"), h)
    q = q.reshape(b, s, cfg.num_attention_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_key_value_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_key_value_heads, cfg.head_dim)
    q = apply_rope_for_config(q, positions, cfg)
    k = apply_rope_for_config(k, positions, cfg)
    return q, k, v


def _mlp(lp, h: torch.Tensor) -> torch.Tensor:
    # a fully int4 MLP at decode rows may run as ONE kernel (K9, opt-in);
    # None means not eligible or not switched on
    y = matmul_q4_mlp(h, lp)
    if y is not None:
        return y
    g, u = linear_group(lp, ("gate", "up"), h)
    return linear(lp, "down", F.silu(g) * u)


def _window_mask(cfg: LlamaConfig, positions: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """``mask`` with the sliding window applied where it binds: for ``S >
    window``, the causal mask (or ``mask``) AND ``q_pos - k_pos < window``
    by position (exact on compacted sequences). ``S <= window`` cannot bind
    on sequential positions, so ``mask`` comes back as it was."""
    win = cfg.sliding_window
    b, s = positions.shape
    if win is None or s <= win:
        return mask
    wmask = sliding_window_mask(positions, positions, win)
    if mask is None:
        mask = make_attention_mask(s, s, causal=True, batch=b, device=positions.device)
    return mask & wmask


def layer_nocache(
    lp,
    cfg: LlamaConfig,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S]
    mask: Optional[torch.Tensor] = None,  # [B, 1, S, S] bool, None = plain causal
    policy: Optional[torch.Tensor] = None,  # [B, S] soft keep mask (training)
) -> torch.Tensor:
    """One decoder layer without a KV cache (the training path). With no
    explicit mask, attention goes through the differentiable kernels (K1
    with K3, or K4 with a policy); padding is NOT masked, as in the JAX
    training path. A Mistral sliding window binds only past ``window``
    tokens: there the mask is the causal one (or ``mask``) ANDed with the
    window by position, on the plain path, as in JAX."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
    q, k, v = _qkv(lp, cfg, h, positions)
    mask = _window_mask(cfg, positions, mask)
    if mask is not None:
        if policy is not None:
            o = attend_with_policy(q, k, v, policy, mask=mask)
        else:
            o = attend(q, k, v, mask=mask)
    else:
        o = self_attend(q, k, v, policy=policy)
    x = x + linear(lp, "o", o.reshape(b, s, -1))
    return x + _mlp(lp, rms_norm(x, lp["post_ln"], cfg.rms_norm_eps))


# What each remat policy saves from a layer's first forward (the JAX
# ``_remat_policy``); everything else is recomputed in the backward.
# ``dots``: the weight products, ``x @ W`` with no batch dimension, which
# ``matmul`` folds into ``mm`` (the attention's own batched products are
# ``bmm`` and are recomputed, as in JAX). ``flash``: the outputs of the
# attention forward ops (F2: K1's out and lse, K4's out), so the backward
# never runs an attention forward again.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_FLASH = (torch.ops.dynamic_llava.flash_forward.default,
          torch.ops.dynamic_llava.flash_policy_forward.default)
REMAT_SAVES = {"nothing": (), "dots": _DOTS, "flash": _FLASH, "flash_dots": _DOTS + _FLASH}
REMAT_POLICIES = (*REMAT_SAVES, "alternate")


def _checkpointed(policy: str, lp, cfg, x, positions, mask, pol) -> torch.Tensor:
    """``layer_nocache`` under activation checkpointing (non-reentrant),
    saving what ``REMAT_SAVES[policy]`` names (selective checkpointing)."""
    saves = REMAT_SAVES[policy]
    kw = {}
    if saves:
        kw["context_fn"] = partial(create_selective_checkpoint_contexts, list(saves))
    return checkpoint(layer_nocache, lp, cfg, x, positions, mask, pol,
                      use_reentrant=False, **kw)


def run_layers_nocache(
    params,
    cfg: LlamaConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    lo: int = 0,
    hi: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
    policy: Optional[torch.Tensor] = None,
    remat: bool = False,
    remat_policy: str = "nothing",
) -> torch.Tensor:
    """Run layers [lo, hi) without a KV cache (training and parity paths).

    ``remat=True`` checkpoints each layer (``torch.utils.checkpoint``,
    non-reentrant) and recomputes it in the backward, except what the
    policy saves: ``"nothing"`` saves only the layer's input (minimum
    memory, the 7B regime); ``"dots"`` the weight products; ``"flash"``
    only the attention outputs (and K1's logsumexp), so the backward never
    re-runs an attention forward; ``"flash_dots"`` both. ``"alternate"``
    takes layers in pairs: the first checkpointed under ``"flash_dots"``,
    the second not checkpointed at all (it needs an even layer count)."""
    hi = cfg.num_hidden_layers if hi is None else hi
    if remat and remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; one of {REMAT_POLICIES}")
    if remat and remat_policy == "alternate" and (hi - lo) % 2:
        raise ValueError(f"remat_policy 'alternate' takes layers in pairs, got [{lo}, {hi})")
    layers = params["layers"]
    if not (remat and torch.is_grad_enabled()):
        for li in range(lo, hi):
            x = layer_nocache(layer_params(layers, li), cfg, x, positions, mask, policy)
        return x
    if remat_policy != "alternate":
        for li in range(lo, hi):
            x = _checkpointed(remat_policy, layer_params(layers, li), cfg, x, positions,
                              mask, policy)
        return x
    for li in range(lo, hi, 2):
        x = _checkpointed("flash_dots", layer_params(layers, li), cfg, x, positions, mask,
                          policy)
        x = layer_nocache(layer_params(layers, li + 1), cfg, x, positions, mask, policy)
    return x


class PrefillResult(NamedTuple):
    x: torch.Tensor  # [B, S, D]
    cache: KVCache


def run_layers_prefill(
    params,
    cfg: LlamaConfig,
    x: torch.Tensor,  # [B, S, D] left-aligned (padding at the tail)
    positions: torch.Tensor,  # [B, S] original positions of each slot
    cache: KVCache,  # covers exactly layers [lo, hi)
    valid_len: torch.Tensor,  # [B] int32 real tokens in x
    *,
    lo: int = 0,
    hi: Optional[int] = None,
) -> PrefillResult:
    """Prefill layers [lo, hi): causal attention over the (possibly
    compacted) sequence, K/V written to cache slots [0, S) IN PLACE (cast
    to the storage dtype, or quantized to int8 with their scales),
    ``length = valid_len``. Attention runs on the unrounded K/V and is
    masked to ``valid_len`` so K1 skips padding tiles; padding rows (which
    the JAX version lets attend the padding too) hold values that are
    never read. A prompt longer than a Mistral ``sliding_window`` attends
    on the plain path under the causal mask AND the window by position, as
    in JAX (padding rows, unmasked by length there, are never read); within
    the window K1 runs."""
    hi = cfg.num_hidden_layers if hi is None else hi
    if cache.num_layers != hi - lo:
        raise ValueError(f"cache has {cache.num_layers} layers for [{lo}, {hi})")
    length = valid_len.to(torch.int32)[None, :].expand(cache.length.shape).clone()
    b, s, _ = x.shape
    win_mask = _window_mask(cfg, positions)
    for li in range(hi - lo):
        lp = layer_params(params["layers"], li + lo)
        h = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, h, positions)
        write_prefill(cache, li, k, v)
        if win_mask is not None:
            o = attend(q, k, v, mask=win_mask)
        else:
            o = self_attend(q, k, v, valid_len=valid_len)
        x = x + linear(lp, "o", o.reshape(b, s, -1))
        x = x + _mlp(lp, rms_norm(x, lp["post_ln"], cfg.rms_norm_eps))
    return PrefillResult(x=x, cache=cache._replace(length=length))


class DecodeResult(NamedTuple):
    x: torch.Tensor  # [B, 1, D] ([B, M, D] from run_layers_extend)
    cache: KVCache  # K/V written at the current slots; lengths NOT advanced
    kept: Optional[torch.Tensor] = None  # [B] persisted-token count (extend only)


def run_layers_decode(
    params,
    cfg: LlamaConfig,
    x: torch.Tensor,  # [B, 1, D] current-token hidden
    positions: torch.Tensor,  # [B, 1] original position of the token
    cache: KVCache,  # covers exactly layers [lo, hi)
    *,
    lo: int = 0,
    hi: Optional[int] = None,
    attend_bound: Optional[torch.Tensor] = None,  # [B] valid-slot bound override
    write_slot: Optional[torch.Tensor] = None,  # [B] write-slot override
) -> DecodeResult:
    """One decode step through layers [lo, hi). Every layer attends over its
    persisted rows ``[0, bound)`` plus the current K/V appended virtually
    (kernel K2 on the card); after the loop all layers' K/V are written at
    the write slot in one pass. The caller advances the lengths.

    ``attend_bound`` / ``write_slot`` default to the tier length (append at
    length); the ring-overflow mode passes a bound saturated at the budget
    and a slot that wraps over the decode region. An int8 cache rides RAW
    with its scales into the attention, an fp8 cache as stored; the current
    token's K/V enter unrounded and are quantized only for the write."""
    hi = cfg.num_hidden_layers if hi is None else hi
    if cache.num_layers != hi - lo:
        raise ValueError(f"cache has {cache.num_layers} layers for [{lo}, {hi})")
    if hi == lo:
        return DecodeResult(x=x, cache=cache)
    b = x.shape[0]
    i32 = torch.int32
    bound = None if attend_bound is None else attend_bound.to(i32).contiguous()
    slots = (cache.length if write_slot is None
             else write_slot.to(i32)[None, :].expand(cache.length.shape))
    q_pos = (None if cfg.sliding_window is None
             else positions[:, 0].to(i32).contiguous())
    k_new, v_new = [], []
    for li in range(hi - lo):
        lp = layer_params(params["layers"], li + lo)
        h = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, h, positions)
        o = decode_attention(
            q, cache.k[li], cache.v[li], k, v,
            cache.length[li] if bound is None else bound,
            window=cfg.sliding_window, q_pos=q_pos,
            k_scale=cache.k_scale[li] if cache.quantized else None,
            v_scale=cache.v_scale[li] if cache.quantized else None,
        )
        x = x + linear(lp, "o", o.reshape(b, 1, -1))
        x = x + _mlp(lp, rms_norm(x, lp["post_ln"], cfg.rms_norm_eps))
        k_new.append(k)
        v_new.append(v)
    k_new, v_new = torch.stack(k_new), torch.stack(v_new)
    if cache.quantized:
        k_new, ks_new = quantize_kv(k_new)
        v_new, vs_new = quantize_kv(v_new)
        write_token_scales(cache.k_scale, cache.v_scale, ks_new, vs_new, slots)
    write_token_layers(cache.k, cache.v, k_new, v_new, slots)
    return DecodeResult(x=x, cache=cache)


def run_layers_extend(
    params,
    cfg: LlamaConfig,
    x: torch.Tensor,  # [B, M, D] new chunk
    positions: torch.Tensor,  # [B, M] original positions of the chunk tokens
    cache: KVCache,  # covers exactly layers [lo, hi); one length for all its layers
    *,
    lo: int = 0,
    hi: Optional[int] = None,
    keep: Optional[torch.Tensor] = None,  # [B, M] bool: persist the token
    chunk_attend: Optional[torch.Tensor] = None,  # [B, M] bool
) -> DecodeResult:
    """Continuation ("chunked") prefill of layers [lo, hi): every chunk
    token attends over the persisted rows ``[0, length)`` plus the chunk
    itself, causal inside it (``extend_attention``: the M-query form of K2
    on the card), on the unrounded chunk K/V; after the loop all layers'
    chunk K/V are written in one pass (``write_chunk_layers``), the kept
    tokens compacted to slots ``[length, length + kept)`` and the dropped
    ones to the scratch slot ``max_len - 1``. Kept tokens past the
    remaining capacity are force-dropped (the ``decode_step`` rule), so the
    returned ``kept`` counts never overrun the tier; the caller advances the
    lengths by them.

    ``chunk_attend`` restricts which chunk tokens later rows may attend:
    row ``j`` sees chunk column ``i < j`` only where ``chunk_attend[b, i]``
    (every row sees itself), which makes a batched pass equal to feeding
    the tokens one by one through ``decode_step``."""
    hi = cfg.num_hidden_layers if hi is None else hi
    if cache.num_layers != hi - lo:
        raise ValueError(f"cache has {cache.num_layers} layers for [{lo}, {hi})")
    b, m, _ = x.shape
    i32 = torch.int32
    if hi == lo:
        return DecodeResult(x=x, cache=cache, kept=torch.zeros(b, dtype=i32, device=x.device))
    max_len = cache.max_len
    length0 = cache.length[0]  # [B], the tier's shared length
    keep_i = (torch.ones((b, m), dtype=i32, device=x.device) if keep is None
              else keep.to(i32))
    # compacted target slot per chunk token; earlier tokens' offsets do not
    # depend on later ones, so clamping after the cumsum is exact
    offsets = torch.cumsum(keep_i, dim=1, dtype=i32) - 1
    remaining = torch.clamp(max_len - 1 - length0, min=0)  # slot max_len - 1 = scratch
    keep_i = keep_i * (offsets < remaining[:, None]).to(i32)
    target = torch.where(keep_i > 0, length0[:, None] + offsets, max_len - 1).to(i32)
    kept = keep_i.sum(dim=1, dtype=i32)
    window = cfg.sliding_window
    q_pos = None if window is None else positions.to(i32).contiguous()
    attend = None if chunk_attend is None else chunk_attend.to(torch.bool).contiguous()
    k_new, v_new = [], []
    for li in range(hi - lo):
        lp = layer_params(params["layers"], li + lo)
        h = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, h, positions)
        o = extend_attention(
            q, cache.k[li], cache.v[li], k.contiguous(), v.contiguous(), length0,
            chunk_attend=attend, window=window, positions=q_pos,
            k_scale=cache.k_scale[li] if cache.quantized else None,
            v_scale=cache.v_scale[li] if cache.quantized else None,
        )
        x = x + linear(lp, "o", o.reshape(b, m, -1))
        x = x + _mlp(lp, rms_norm(x, lp["post_ln"], cfg.rms_norm_eps))
        k_new.append(k)
        v_new.append(v)
    write_chunk_layers(cache, torch.stack(k_new), torch.stack(v_new), target)
    return DecodeResult(x=x, cache=cache, kept=kept)


def forward_dense(
    params,
    cfg: LlamaConfig,
    input_ids: torch.Tensor,  # [B, S]
    *,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full dense causal-LM forward without a cache (``run_layers_nocache``,
    the sliding window applied where it binds); fp32 logits ``[B, S, V]``.
    The no-cache reference the cached paths are held to."""
    b, s = input_ids.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=input_ids.device)[None].expand(b, s)
    x = embed_tokens(params, input_ids)
    x = run_layers_nocache(params, cfg, x, positions)
    return lm_head(params, cfg, x)
