"""LLaMA decoder (counterpart of ``dynamic_llava_tpu/models/llama.py``),
LoRA-free, with bf16/fp32 or weight-only int8/int4 linears.

Params are the JAX pytree with torch tensors: layer weights stacked along
a leading ``[L, ...]`` axis, linears stored ``[in, out]`` (forward
``x @ W``). Python loops over layers replace ``lax.scan``; ``layers[name][i]``
is a view, so no weights are copied. A quantized weight is a dict leaf
(``ops.quant``) and every linear goes through ``ops.quant.linear`` /
``linear_group``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import LlamaConfig
from ..ops.attention import attend, attend_with_policy, self_attend
from ..ops.decode_attention import decode_attention
from ..ops.kv_cache import (
    KVCache, quantize_kv, write_prefill, write_token_layers, write_token_scales)
from ..ops.norm import rms_norm
from ..ops.quant import (
    dequantize_weight, is_quantized, linear, linear_group, matmul, matmul_q4_mlp,
    unpack_int4)
from ..ops.rope import apply_rope_for_config


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s weights as views into the stacked tensors; a quantized
    leaf gives ``{"q"|"q4": w[i], "s": s[i]}``. A leaf may also be a list of
    per-layer tensors (the trainer's gradient-carrying views)."""
    return {
        name: {k: t[i] for k, t in w.items()} if is_quantized(w) else w[i]
        for name, w in layers.items()
    }


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
    training path."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
    q, k, v = _qkv(lp, cfg, h, positions)
    if mask is not None:
        if policy is not None:
            o = attend_with_policy(q, k, v, policy, mask=mask)
        else:
            o = attend(q, k, v, mask=mask)
    else:
        o = self_attend(q, k, v, policy=policy)
    x = x + linear(lp, "o", o.reshape(b, s, -1))
    return x + _mlp(lp, rms_norm(x, lp["post_ln"], cfg.rms_norm_eps))


REMAT_POLICIES_WAITING = ("dots", "flash", "flash_dots", "alternate")


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

    ``remat=True`` with ``remat_policy="nothing"`` saves only each layer's
    input and recomputes the whole layer in the backward
    (``torch.utils.checkpoint``, non-reentrant): the minimum-memory regime
    of 7B training. The JAX package's other policies (``dots``, ``flash``,
    ``flash_dots``, ``alternate``) are not ported yet and raise."""
    hi = cfg.num_hidden_layers if hi is None else hi
    if remat and remat_policy != "nothing":
        if remat_policy in REMAT_POLICIES_WAITING:
            raise NotImplementedError(
                f"remat_policy={remat_policy!r} is not ported yet; use 'nothing'")
        raise ValueError(f"unknown remat_policy {remat_policy!r}")
    layers = params["layers"]
    for li in range(lo, hi):
        lp = layer_params(layers, li)
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer_nocache, lp, cfg, x, positions, mask, policy,
                           use_reentrant=False)
        else:
            x = layer_nocache(lp, cfg, x, positions, mask, policy)
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
    never read. The Mistral prefill window mask is not ported: a prompt
    longer than ``cfg.sliding_window`` raises."""
    hi = cfg.num_hidden_layers if hi is None else hi
    if cache.num_layers != hi - lo:
        raise ValueError(f"cache has {cache.num_layers} layers for [{lo}, {hi})")
    length = valid_len.to(torch.int32)[None, :].expand(cache.length.shape).clone()
    b, s, _ = x.shape
    if cfg.sliding_window is not None and s > cfg.sliding_window:
        raise NotImplementedError(
            f"prefill of {s} tokens with sliding_window={cfg.sliding_window}: "
            "the prefill window mask is not ported yet")
    for li in range(hi - lo):
        lp = layer_params(params["layers"], li + lo)
        h = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, h, positions)
        write_prefill(cache, li, k, v)
        o = self_attend(q, k, v, valid_len=valid_len)
        x = x + linear(lp, "o", o.reshape(b, s, -1))
        x = x + _mlp(lp, rms_norm(x, lp["post_ln"], cfg.rms_norm_eps))
    return PrefillResult(x=x, cache=cache._replace(length=length))


class DecodeResult(NamedTuple):
    x: torch.Tensor  # [B, 1, D]
    cache: KVCache  # K/V written at the current slots; lengths NOT advanced


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
