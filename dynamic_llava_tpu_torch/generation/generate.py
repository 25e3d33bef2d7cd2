"""Autoregressive generation (counterpart of
``dynamic_llava_tpu/generation/generate.py``).

``Generator.generate`` plans the batch on the host (``plan_batch``, reused
from the JAX package), runs ``dynamic.prefill``, then a Python loop of
``dynamic.decode_step``. Sampled tokens stay on the device and feed the
next step directly; the host syncs once per ``decode_chunk`` tokens to
resolve EOS and stopping, and the returned lists are cut exactly at the
stop point. CUDA graphs of the decode step are left to a later version.

Lean-memory options, as in the JAX package: ``cache_dtype`` stores the KV
cache in bf16 / fp32, scaled int8 (``"int8"``) or fp8
(``"float8_e4m3fn"``); ``kv_overflow="ring"`` with ``kv_window`` bounds
both tiers for long generations (each new token past the budget evicts the
oldest decode entry).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import LlavaConfig
from ..models import dynamic
from ..multimodal.fusion import FusionPlan, plan_batch


class GenerationConfig(NamedTuple):
    """Same fields and defaults as the JAX ``GenerationConfig``.
    ``cache_dtype`` is one of ``CACHE_DTYPES``; ``kv_overflow`` is ``"drop"``
    (force-drop once the post tier's budget fills) or ``"ring"`` (evict the
    oldest decode entry; incompatible with a sliding-window model);
    ``kv_window`` caps the decode headroom (the ring's window size)."""

    max_new_tokens: int = 128
    temperature: float = 0.0
    top_p: float = 1.0
    eos_token_id: int = 2
    cache_dtype: str = "bfloat16"
    bound_kv_budget: bool = True
    decode_chunk: int = 32
    pad_multiple: int = 64
    seed: int = 0
    kv_overflow: str = "drop"
    kv_window: Optional[int] = None


CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn}


def _sample(generator: Optional[torch.Generator], logits: torch.Tensor,
            temperature: float, top_p: float) -> torch.Tensor:
    """Greedy (first maximum, like ``jnp.argmax``) at temperature 0; else
    temperature / top-p sampling from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class Generator:
    """Generation harness for fixed params, model config and generation
    config. ``params`` is the port's param tree (``weights``), all on one
    device; inputs are moved there."""

    def __init__(self, params, cfg: LlavaConfig,
                 gen_cfg: GenerationConfig = GenerationConfig()):
        if gen_cfg.kv_overflow not in ("drop", "ring"):
            raise ValueError(
                f"kv_overflow must be 'drop' or 'ring', got {gen_cfg.kv_overflow!r}")
        if gen_cfg.cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"cache_dtype must be one of {sorted(CACHE_DTYPES)}, "
                             f"got {gen_cfg.cache_dtype!r}")
        self.params = params
        self.cfg = cfg
        self.gen_cfg = gen_cfg
        # the final norm is a plain tensor; the embed may be a quantized dict
        self.device = params["llm"]["final_ln"].device

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def prefill_from_plan(self, plan: FusionPlan, pixel_values, max_new_tokens: int):
        gc = self.gen_cfg
        all_have_image = pixel_values is not None and bool(
            np.asarray(plan.spans.has_image).all()
        )
        cache = dynamic.make_gen_cache(
            self.cfg, plan.batch, plan.seq_len, max_new_tokens,
            CACHE_DTYPES[gc.cache_dtype],
            bound_output_budget=gc.bound_kv_budget,
            all_have_image=all_have_image,
            bucket=gc.pad_multiple,
            decode_window=gc.kv_window,
            ring=gc.kv_overflow == "ring",
            device=self.device,
        )
        pix = None if pixel_values is None else self._tensor(pixel_values)
        i32 = torch.int32
        return dynamic.prefill(
            self.params, self.cfg,
            self._tensor(plan.token_ids, i32),
            self._tensor(plan.is_image, torch.bool),
            self._tensor(plan.image_slot, i32),
            self._tensor(plan.valid_len, i32),
            self._tensor(plan.spans.image_start, i32),
            self._tensor(plan.spans.last_instruct_start, i32),
            self._tensor(plan.spans.last_instruct_end, i32),
            self._tensor(plan.spans.has_image, torch.bool),
            pix,
            cache,
            all_have_image=all_have_image,
            ring_mode=gc.kv_overflow == "ring",
        )

    def cache_lengths(self, state: dynamic.GenState) -> np.ndarray:
        """Per-layer persisted KV lengths ``[L, B]``, pre tier then post."""
        return torch.cat([state.cache.pre.length, state.cache.post.length]).cpu().numpy()

    @torch.inference_mode()
    def generate(
        self,
        input_ids_list: List[np.ndarray],
        pixel_values: Optional[np.ndarray] = None,  # [B, H, W, 3] normalized
        stopping_criteria=None,
        pad_to: Optional[int] = None,
        seed: Optional[int] = None,
        on_chunk=None,  # callback(sample_idx, new_token_ids) for streaming
    ) -> List[List[int]]:
        """Generated token ids (without the prompt) per sample."""
        gc = self.gen_cfg
        plan = plan_batch(
            input_ids_list,
            self.cfg.num_image_tokens if pixel_values is not None else 0,
            max_length=self.cfg.model_max_length,
            pad_to=pad_to,
            pad_multiple=None if pad_to is not None else gc.pad_multiple,
        )
        chunk = max(1, min(gc.decode_chunk, gc.max_new_tokens))
        # the cache has room for whole chunks, as in the JAX generator
        n_chunks = -(-gc.max_new_tokens // chunk)
        state, _ = self.prefill_from_plan(plan, pixel_values, n_chunks * chunk)

        generator = None
        if gc.temperature > 0.0:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(gc.seed if seed is None else seed)
        b = plan.batch
        done = np.zeros(b, bool)
        out: List[List[int]] = [[] for _ in range(b)]
        prompts = [
            list(np.asarray(plan.token_ids[i][: plan.valid_len[i]]))
            for i in range(b)
        ] if stopping_criteria is not None else None
        for _ in range(n_chunks):
            toks = []
            for _ in range(chunk):
                tok = _sample(generator, state.last_logits, gc.temperature, gc.top_p)
                state = dynamic.decode_step(self.params, self.cfg, tok, state,
                                            kv_overflow=gc.kv_overflow)
                toks.append(tok)
            toks_np = torch.stack(toks).cpu().numpy()  # ONE host sync per chunk
            for i in range(b):
                if done[i]:
                    continue
                fresh: List[int] = []
                for j in range(toks_np.shape[0]):
                    if len(out[i]) >= gc.max_new_tokens:
                        done[i] = True
                        break
                    t = int(toks_np[j, i])
                    out[i].append(t)
                    fresh.append(t)
                    if t == gc.eos_token_id:
                        done[i] = True
                        break
                    if stopping_criteria is not None and stopping_criteria(
                        prompts[i] + out[i]
                    ):
                        done[i] = True
                        break
                if on_chunk is not None and fresh:
                    on_chunk(i, fresh)
            if done.all():
                break
        return out
