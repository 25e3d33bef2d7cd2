"""Long-generation speed / memory probes: the port's counterpart of
``dynamic_llava_tpu/eval/bench_test.py`` (the reference's bench_test
scripts):

* ``long_text_memory``: decode memory and KV-cache growth against the
  output length with the cache (``dynamic_llava_long_text_mem.py``): at
  every checkpoint the persisted KV lengths of both tiers, the cache's
  capacity bytes and the device memory. Greedy, one eager
  ``dynamic.decode_step`` a token (the JAX probe calls the jitted step a
  token).
* ``long_text_no_cache_timing``: multi-round full-recompute forward timing
  (``dynamic_llava_long_text_time_with_no_cache.py``, ``use_cache=False``):
  each round appends tokens and re-runs the hard-pruned forward
  (``dynamic.forward_nocache_eval``: K1 on the card) over the whole
  sequence, recording its latency (the second of two runs, after
  ``synchronize``) and its kept length.

Both run on random or loaded params: they measure machinery, not answer
quality.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import LlavaConfig
from ..models import dynamic
from ..multimodal.fusion import plan_batch
from ..profiling import resolve
from .bench import bf16_pixels, build_inputs, sync


def _device_mem(device) -> Dict[str, float]:
    """The allocator's bytes in use and peak on the card; 0.0 each where
    the device keeps no stats (the CPU), as the JAX function reports them."""
    from ..profiling import CURRENT_KEY, PEAK_KEY, device_memory_stats

    s = device_memory_stats(device)
    return {
        "bytes_in_use_gb": round(s.get(CURRENT_KEY, 0) / 2**30, 3),
        "peak_bytes_gb": round(s.get(PEAK_KEY, 0) / 2**30, 3),
    }


@contextlib.contextmanager
def _records_to(record_file: Optional[str]):
    """A function that streams a record to ``record_file`` as a JSON line
    (flushed), or drops it where there is no file."""
    if not record_file:
        yield lambda rec: None
        return
    with open(record_file, "w") as f:
        def write(rec):
            f.write(json.dumps(rec) + "\n")
            f.flush()

        yield write


def cache_bytes(state: dynamic.GenState) -> int:
    """Bytes of both tiers' K and V (the scales of an int8 cache apart)."""
    n = 0
    for tier in (state.cache.pre, state.cache.post):
        n += tier.k.numel() * tier.k.element_size() * 2
    return n


def plan_tensors(plan, device, answer_start: bool = False):
    """The plan's arrays as ``dynamic.prefill`` (or, with ``answer_start``,
    ``forward_nocache_eval``) takes them, on ``device``."""
    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    sp = plan.spans
    return (t(plan.token_ids), t(plan.is_image, torch.bool), t(plan.image_slot),
            t(plan.valid_len), t(sp.image_start),
            *((t(sp.answer_start),) if answer_start else ()),
            t(sp.last_instruct_start), t(sp.last_instruct_end), t(sp.has_image, torch.bool))


@torch.inference_mode()
def long_text_memory(
    params,
    cfg: LlavaConfig,
    batch: int = 1,
    text_len: int = 64,
    max_new: int = 512,
    checkpoint_every: int = 64,
    record_file: Optional[str] = None,
) -> List[Dict]:
    """Greedy-decode ``max_new`` tokens, recording KV / memory stats every
    ``checkpoint_every`` steps and at the last."""
    dev = resolve(model_params=params)
    plan, imgs = build_inputs(cfg, batch, text_len)
    cache = dynamic.make_gen_cache(cfg, batch, plan.seq_len, max_new, torch.bfloat16,
                                   device=dev)
    pixels = torch.from_numpy(bf16_pixels(imgs)).to(dev)
    state, _ = dynamic.prefill(params, cfg, *plan_tensors(plan, dev), pixels, cache)
    records = []
    tok = torch.argmax(state.last_logits, dim=-1)
    with _records_to(record_file) as out:
        for step in range(1, max_new + 1):
            state = dynamic.decode_step(params, cfg, tok, state)
            tok = torch.argmax(state.last_logits, dim=-1)
            if step % checkpoint_every == 0 or step == max_new:
                rec = {
                    "output_token_length": step,
                    "pre_cache_length": int(state.cache.pre.length[0, 0].item()),
                    "output_cache_length": int(state.cache.post.length[-1, 0].item()),
                    "cache_capacity_bytes": cache_bytes(state),
                    **_device_mem(dev),
                }
                records.append(rec)
                out(rec)
    return records


@torch.inference_mode()
def long_text_no_cache_timing(
    params,
    cfg: LlavaConfig,
    text_len: int = 32,
    rounds: int = 8,
    tokens_per_round: int = 32,
    record_file: Optional[str] = None,
) -> List[Dict]:
    """Full-recompute (``use_cache=False``) timing: round r re-runs the
    hard-pruned forward over the prompt + r * ``tokens_per_round`` appended
    tokens."""
    dev = resolve(model_params=params)
    rng = np.random.default_rng(0)
    base_ids = rng.integers(3, cfg.text.vocab_size, size=(text_len,)).astype(np.int64)
    base_ids[min(8, text_len - 2)] = -200
    imgs = rng.normal(size=(1, cfg.vision.image_size, cfg.vision.image_size, 3))
    pixels = torch.from_numpy(bf16_pixels(imgs.astype(np.float32))).to(dev)

    records = []
    appended: List[int] = []
    with _records_to(record_file) as out:
        for r in range(rounds):
            ids = np.concatenate([base_ids, np.asarray(appended, np.int64)])
            labels = np.full_like(ids, -100)
            if appended:
                labels[-len(appended):] = ids[-len(appended):]
            plan = plan_batch([ids], cfg.num_image_tokens, labels_list=[labels])
            args = plan_tensors(plan, dev, answer_start=True)
            # the first run apart (the kernels' first launch and the allocator)
            dynamic.forward_nocache_eval(params, cfg, *args, pixels)
            sync(dev)
            t0 = time.perf_counter()
            _, kept = dynamic.forward_nocache_eval(params, cfg, *args, pixels)
            sync(dev)
            dt = time.perf_counter() - t0
            rec = {
                "round": r,
                "total_length": int(plan.valid_len[0]),
                "kept_length": int(kept[0].item()),
                "forward_ms": round(dt * 1e3, 3),
                **_device_mem(dev),
            }
            records.append(rec)
            out(rec)
            appended.extend(
                rng.integers(3, cfg.text.vocab_size, size=(tokens_per_round,)).tolist()
            )
    return records
