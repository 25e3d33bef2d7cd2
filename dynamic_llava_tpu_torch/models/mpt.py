"""MPT decoder, the third base family (counterpart of
``dynamic_llava_tpu/models/mpt.py``).

The LLaVA-MPT checkpoints differ from the LLaMA family in the decoder only:
ALiBi position bias instead of RoPE, a fused Wqkv projection, bias-free
LayerNorm instead of RMSNorm, a plain 4x GELU MLP instead of the gated SiLU
one, and a tied lm_head. The layout follows the port's LLaMA decoder:
stacked ``[L, ...]`` leaves, ``[in, out]`` linears, Python loops over
layers, the shared ``KVCache`` written in place. Attention takes the plain
path only (``ops.attention.attend`` with ``bias=``): the flash kernels are
rope-only, and MPT is a dense baseline, as in the JAX package.

ALiBi: HF builds ``slope_h * (k - S + 1)`` and relies on softmax shift
invariance; the relative form ``slope_h * (k_pos - q_pos)`` used here
differs per query row by a constant, so it is softmax-identical.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MptConfig
from ..ops.attention import attend, make_attention_mask
from ..ops.kv_cache import KVCache, init_cache, write_prefill, write_token_layers
from ..ops.norm import layer_norm
from ..ops.quant import matmul
from ..weights import _Init, resolve_device
from .convert import _put, _stack


def alibi_slopes(n_heads: int, alibi_bias_max: int = 8) -> np.ndarray:
    """Per-head ALiBi slopes in HF / MPT order (padded to a power of two,
    then the odd-index heads first when ``n_heads`` is not one)."""
    n_pow2 = 2 ** math.ceil(math.log2(n_heads))
    base = np.arange(1, n_pow2 + 1, dtype=np.float64) * (alibi_bias_max / n_pow2)
    slopes = 1.0 / np.power(2.0, base)
    if n_pow2 != n_heads:
        slopes = np.concatenate([slopes[1::2], slopes[::2]])[:n_heads]
    return slopes.astype(np.float32)


def alibi_bias(
    cfg: MptConfig,
    q_pos: torch.Tensor,  # [B, Sq] int
    k_pos: torch.Tensor,  # [B, Sk] or [Sk] int
) -> torch.Tensor:
    """Relative-form ALiBi ``[B, H, Sq, Sk] = slope_h * (k_pos - q_pos)``,
    fp32: negative for past keys."""
    if k_pos.dim() == 1:
        k_pos = k_pos[None]
    rel = (k_pos[:, None, :] - q_pos[:, :, None]).float()
    slopes = torch.from_numpy(alibi_slopes(cfg.n_heads, cfg.alibi_bias_max)).to(q_pos.device)
    return rel[:, None] * slopes[None, :, None, None]


def init_mpt_params(generator: torch.Generator, cfg: MptConfig, device=None,
                    dtype: torch.dtype = torch.float32) -> dict:
    """Random params with the structure of the JAX ``init_mpt_params``
    (normal(0, 0.02) weights, unit norms), drawn from ``generator`` on
    ``device`` (default: the card)."""
    it = _Init(generator, resolve_device(device), dtype)
    d, f, n = cfg.d_model, cfg.expansion_ratio * cfg.d_model, cfg.n_layers
    params = {
        "wte": it.normal(cfg.vocab_size, d),
        "layers": {
            "norm1": it.ones(n, d),
            "wqkv": it.normal(n, d, 3 * d),
            "out": it.normal(n, d, d),
            "norm2": it.ones(n, d),
            "up": it.normal(n, d, f),
            "down": it.normal(n, f, d),
        },
        "final_ln": it.ones(d),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = it.normal(d, cfg.vocab_size)
    return params


def mpt_params_from_state_dict(sd: dict, cfg: MptConfig, device=None,
                               dtype: Optional[torch.dtype] = torch.float32) -> dict:
    """An HF ``MptForCausalLM`` state dict -> the stacked tree on ``device``
    (default: the card): torch ``[out, in]`` linears transposed to ``[in,
    out]``, per-layer tensors stacked on a leading axis."""
    device = resolve_device(device)
    n = cfg.n_layers

    def stack(fmt, transpose=False):
        return _stack(sd, [fmt.format(i) for i in range(n)], device, dtype, transpose)

    p = "transformer."
    params = {
        "wte": _put(sd[p + "wte.weight"], device, dtype),
        "layers": {ours: stack(p + "blocks.{}." + theirs + ".weight", transpose)
                   for ours, (theirs, transpose) in _LAYER_KEYS.items()},
        "final_ln": _put(sd[p + "norm_f.weight"], device, dtype),
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = _put(sd["lm_head.weight"], device, dtype, transpose=True)
    return params


_LAYER_KEYS = {"norm1": ("norm_1", False), "wqkv": ("attn.Wqkv", True),
               "out": ("attn.out_proj", True), "norm2": ("norm_2", False),
               "up": ("ffn.up_proj", True), "down": ("ffn.down_proj", True)}


def mpt_state_dict(params: dict) -> dict:
    """The inverse of ``mpt_params_from_state_dict``: HF ``MptForCausalLM``
    names, torch ``[out, in]`` linears, one tensor a layer (each with a
    storage of its own), on the params' device."""
    p = "transformer."
    sd = {p + "wte.weight": params["wte"].clone(), p + "norm_f.weight": params["final_ln"].clone()}
    for ours, (theirs, transpose) in _LAYER_KEYS.items():
        for i, w in enumerate(params["layers"][ours]):
            sd[f"{p}blocks.{i}.{theirs}.weight"] = (w.T if transpose else w).contiguous().clone()
    if "lm_head" in params:
        sd["lm_head.weight"] = params["lm_head"].T.contiguous()
    return sd


def embed_tokens(params, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids.long(), params["wte"])


def _ln(x: torch.Tensor, w: torch.Tensor, cfg: MptConfig) -> torch.Tensor:
    return layer_norm(x, w, 0.0, cfg.layer_norm_epsilon)  # bias-free


def lm_head(params, cfg: MptConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm + vocabulary projection (the tied ``wte`` unless the
    params hold an ``lm_head``); fp32 logits."""
    x = _ln(x, params["final_ln"], cfg)
    w = params["wte"].T if "lm_head" not in params else params["lm_head"]
    return matmul(x, w, out_fp32=True)


def _layer(layers: dict, i: int) -> dict:
    return {name: w[i] for name, w in layers.items()}


def _qkv(lp, cfg: MptConfig, h: torch.Tensor):
    b, s, _ = h.shape
    mixed = h @ lp["wqkv"]
    if cfg.clip_qkv:
        mixed = torch.clamp(mixed, -cfg.clip_qkv, cfg.clip_qkv)
    q, k, v = torch.chunk(mixed, 3, dim=-1)
    shape = (b, s, cfg.n_heads, cfg.head_dim)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def _scale(cfg: MptConfig) -> float:
    return cfg.softmax_scale or cfg.head_dim ** -0.5


def _block(lp, cfg: MptConfig, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """The residual tail: attention output projection, then the MLP."""
    b, s, _ = x.shape
    x = x + o.reshape(b, s, -1) @ lp["out"]
    h = _ln(x, lp["norm2"], cfg)
    return x + F.gelu(h @ lp["up"], approximate="none") @ lp["down"]


def _layers_nocache(params, cfg: MptConfig, x: torch.Tensor,
                    valid_len: Optional[torch.Tensor]) -> torch.Tensor:
    """Every layer over a whole sequence at sequential positions, causal
    (and ``valid_len``-masked) with ALiBi."""
    b, s, _ = x.shape
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    mask = make_attention_mask(s, s, causal=True, kv_length=valid_len, batch=b,
                               device=x.device)
    bias = alibi_bias(cfg, pos, pos)
    for li in range(cfg.n_layers):
        lp = _layer(params["layers"], li)
        q, k, v = _qkv(lp, cfg, _ln(x, lp["norm1"], cfg))
        o = attend(q, k, v, mask=mask, bias=bias, scale=_scale(cfg))
        x = _block(lp, cfg, x, o)
    return x


def forward_dense(
    params,
    cfg: MptConfig,
    input_ids: torch.Tensor,  # [B, S]
    *,
    valid_len: Optional[torch.Tensor] = None,  # [B] mask padding keys
) -> torch.Tensor:
    """The whole dense causal-LM forward with ALiBi; fp32 logits ``[B, S, V]``."""
    x = embed_tokens(params, input_ids.to(params["wte"].device))
    return lm_head(params, cfg, _layers_nocache(params, cfg, x, valid_len))


class MptStepResult(NamedTuple):
    x: torch.Tensor
    cache: KVCache


def run_layers_prefill(
    params,
    cfg: MptConfig,
    x: torch.Tensor,  # [B, S, D] embedded, left-aligned
    positions: torch.Tensor,  # [B, S]
    cache: KVCache,
    valid_len: torch.Tensor,  # [B]
) -> MptStepResult:
    """Prefill every layer: K/V written to slots ``[0, S)`` IN PLACE,
    ``length = valid_len``."""
    b, s, _ = x.shape
    mask = make_attention_mask(s, s, causal=True, batch=b, device=x.device)
    bias = alibi_bias(cfg, positions, positions)
    for li in range(cfg.n_layers):
        lp = _layer(params["layers"], li)
        q, k, v = _qkv(lp, cfg, _ln(x, lp["norm1"], cfg))
        write_prefill(cache, li, k, v)
        o = attend(q, k, v, mask=mask, bias=bias, scale=_scale(cfg))
        x = _block(lp, cfg, x, o)
    length = valid_len.to(torch.int32)[None, :].expand(cache.length.shape).clone()
    return MptStepResult(x=x, cache=cache._replace(length=length))


def run_layers_decode(
    params,
    cfg: MptConfig,
    x: torch.Tensor,  # [B, 1, D]
    positions: torch.Tensor,  # [B, 1] current token position
    cache: KVCache,
) -> MptStepResult:
    """One decode step through every layer: each attends its cache rows
    ``[0, length)`` plus the current K/V appended; then every layer's K/V
    is written at slot ``length`` IN PLACE. The caller advances the
    lengths. The dense cache's slot == position gives the ALiBi key
    positions."""
    b = x.shape[0]
    max_len = cache.max_len
    cols = torch.arange(max_len, dtype=torch.int32, device=x.device)
    # [B, H, 1, max_len + 1]: the cache's columns, then the current token's 0
    bias = torch.cat([alibi_bias(cfg, positions, cols),
                      torch.zeros((b, cfg.n_heads, 1, 1), device=x.device)], dim=-1)
    k_new, v_new = [], []
    for li in range(cfg.n_layers):
        lp = _layer(params["layers"], li)
        q, k, v = _qkv(lp, cfg, _ln(x, lp["norm1"], cfg))
        k_cat = torch.cat([cache.k[li].to(q.dtype), k], dim=1)
        v_cat = torch.cat([cache.v[li].to(q.dtype), v], dim=1)
        mask = torch.cat([(cols[None, :] < cache.length[li][:, None])[:, None, None, :],
                          torch.ones((b, 1, 1, 1), dtype=torch.bool, device=x.device)],
                         dim=-1)
        o = attend(q, k_cat, v_cat, mask=mask, bias=bias, scale=_scale(cfg))
        x = _block(lp, cfg, x, o)
        k_new.append(k)
        v_new.append(v)
    write_token_layers(cache.k, cache.v, torch.stack(k_new), torch.stack(v_new), cache.length)
    return MptStepResult(x=x, cache=cache)


def forward_multimodal(
    params,  # {"llm": MPT params, "vision_tower": CLIP, "mm_projector": [...]}
    cfg: MptConfig,
    vision_cfg,  # ClipVisionConfig
    plan_token_ids: torch.Tensor,  # [B, S]
    plan_is_image: torch.Tensor,  # [B, S] bool
    plan_image_slot: torch.Tensor,  # [B, S] int
    pixel_values: Optional[torch.Tensor],  # [B, H, W, 3] normalized
    valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The dense LLaVA-MPT forward: CLIP tower (K1 on the card) ->
    projector -> embedding splice -> the ALiBi decoder at sequential
    positions (image patches take ordinary positions). fp32 logits
    ``[B, S, V]``."""
    from ..multimodal.fusion import fuse_embeddings
    from . import clip, projector

    dev = params["llm"]["wte"].device
    x = embed_tokens(params["llm"], plan_token_ids.to(dev))
    if pixel_values is not None:
        feats = clip.vision_tower_features(params["vision_tower"], vision_cfg,
                                           pixel_values.to(dev))
        feats = projector.apply_projector(params["mm_projector"], feats)
        x = fuse_embeddings(x, feats, plan_is_image.to(dev), plan_image_slot.to(dev))
    if valid_len is not None:
        valid_len = valid_len.to(dev)
    return lm_head(params["llm"], cfg, _layers_nocache(params["llm"], cfg, x, valid_len))


def generate_greedy(
    params,
    cfg: MptConfig,
    input_ids: torch.Tensor,  # [B, S] (fully valid)
    max_new_tokens: int,
    eos_token_id: Optional[int] = None,
) -> torch.Tensor:
    """Greedy decode on a static fp32 cache of ``S + max_new + 1`` slots,
    an eager loop of ``run_layers_decode`` (the JAX ``lax.scan``); returns
    ``[B, max_new]`` token ids (post-EOS positions repeat EOS)."""
    dev = params["wte"].device
    ids = input_ids.to(dev)
    b, s = ids.shape
    i32 = dict(dtype=torch.int32, device=dev)
    with torch.inference_mode():
        cache = init_cache(cfg, b, s + max_new_tokens + 1, dtype=torch.float32, device=dev)
        pos = torch.arange(s, **i32)[None].expand(b, s)
        res = run_layers_prefill(params, cfg, embed_tokens(params, ids), pos, cache,
                                 torch.full((b,), s, **i32))
        cache = res.cache
        logits = lm_head(params, cfg, res.x)[:, s - 1]
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        toks = []
        for i in range(max_new_tokens):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            if eos_token_id is not None:
                tok = torch.where(done, eos_token_id, tok).to(torch.int32)
                done = done | (tok == eos_token_id)
            d = run_layers_decode(params, cfg, embed_tokens(params, tok[:, None]),
                                  torch.full((b, 1), s + i, **i32), cache)
            cache = d.cache._replace(length=d.cache.length + 1)
            logits = lm_head(params, cfg, d.x)[:, 0]
            toks.append(tok)
    return torch.stack(toks, dim=1)
