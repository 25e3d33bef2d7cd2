"""Card-side checks of graph decode in the port's ``Generator``: at a small
width (a GQA decoder with head_dim 64), ``generate`` replays a captured
CUDA graph of the decode step and gives the tokens of an eager loop of
``_sample`` + ``decode_step`` from the same prefill, with bf16, int8 and
int4 weights, the fused int4 MLP (K9), int8 and fp8 KV caches, the ring
policy past both wraps, and temperature / top-p sampling from one seed.
Replays run under ``torch.cuda.set_sync_debug_mode("error")``, and the
kernels they launch on the card, counted in a ``torch.profiler`` trace
(``kernel_cases.device_launches``), are those the eager loop's wrappers
launch for as many steps (K2 once a layer and step, K9 as often with the
switch on and never with it off).

It imports torch and the port only, so it also runs where jax is not
installed. Every test needs an NVIDIA GPU and ``nvcc`` (the kernels are
built at first use) and is skipped without them:

    python -m pytest --noconftest tests/test_torch_card_graph.py
"""

import os

import numpy as np
import pytest
import torch

from dynamic_llava_tpu_torch import kernel_cases as kc
from dynamic_llava_tpu_torch import kernels
from dynamic_llava_tpu_torch.config import (
    IMAGE_TOKEN_INDEX, ClipVisionConfig, LlamaConfig, LlavaConfig, SparseConfig)
from dynamic_llava_tpu_torch.generation import generate as tgen
from dynamic_llava_tpu_torch.models import dynamic
from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
from dynamic_llava_tpu_torch.ops.quant import quantize_llm_params
from dynamic_llava_tpu_torch.weights import init_llava_params

pytestmark = pytest.mark.card

CFG = LlavaConfig(
    text=LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                          num_key_value_heads=2),
    vision=ClipVisionConfig.tiny(hidden_size=128, intermediate_size=256, num_attention_heads=2),
    sparse=SparseConfig(d_model=64, nhead=2, dim_feedforward=128, num_layers=1,
                        output_text_len_for_training=8),
)
BASE = dict(max_new_tokens=24, decode_chunk=8, pad_multiple=8, eos_token_id=-1)
# mode -> (weight bits, fused int4 MLP, GenerationConfig fields)
MODES = {
    "bf16": (None, False, {}),
    "int8": (8, False, {}),
    "int4": (4, False, {}),
    "int4 fused MLP": (4, True, {}),
    "int8 KV": (None, False, dict(cache_dtype="int8")),
    "fp8 KV": (None, False, dict(cache_dtype="float8_e4m3fn")),
    "ring": (None, False, dict(cache_dtype="int8", kv_overflow="ring", kv_window=2,
                               max_new_tokens=48)),
    "sampling": (None, False, dict(temperature=0.8, top_p=0.9)),
}


@pytest.fixture(scope="module", autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU or interpret mode")
    return kernels.load_library()


@pytest.fixture
def q4_mlp_switch():
    saved = os.environ.pop("DYNAMIC_LLAVA_Q4_MLP", None)
    yield
    os.environ.pop("DYNAMIC_LLAVA_Q4_MLP", None)
    if saved is not None:
        os.environ["DYNAMIC_LLAVA_Q4_MLP"] = saved


def _batch():
    rng = np.random.default_rng(0)
    ids = [np.concatenate([rng.integers(3, 500, 7), [IMAGE_TOKEN_INDEX],
                           rng.integers(3, 500, 9 + i)]) for i in range(3)]
    size = CFG.vision.image_size
    return ids, rng.standard_normal((3, size, size, 3), dtype=np.float32)


def _eager_loop(gen, plan, pix, steps, seed):
    """Prefill, then ``steps`` of ``_sample`` + ``decode_step``: ``[steps, B]``
    tokens, and the serving kernels' wrapper calls of the steps."""
    gc = gen.gen_cfg
    sampler = None
    if gc.temperature > 0:
        sampler = torch.Generator(device=gen.device).manual_seed(seed)
    with torch.inference_mode():
        state, _ = gen.prefill_from_plan(plan, pix, steps)
        before = kc.read_counters()
        toks = []
        for _ in range(steps):
            tok = tgen._sample(sampler, state.last_logits, gc.temperature, gc.top_p)
            state = dynamic.decode_step(gen.params, gen.cfg, tok, state,
                                        kv_overflow=gc.kv_overflow)
            toks.append(tok)
        calls = kc.wrapper_calls(before, kc.read_counters())
    return torch.stack(toks).cpu().numpy(), calls


@pytest.mark.parametrize("mode", list(MODES))
def test_graph_decode_matches_the_eager_loop(mode, q4_mlp_switch):
    bits, fused, over = MODES[mode]
    params = init_llava_params(CFG, torch.Generator(device="cuda").manual_seed(0), "cuda",
                               torch.bfloat16)
    if bits:
        quantize_llm_params(params, bits=bits)
    if fused:
        os.environ["DYNAMIC_LLAVA_Q4_MLP"] = "1"
    gc = tgen.GenerationConfig(**dict(BASE, **over))
    gen = tgen.Generator(params, CFG, gc)
    ids, pix = _batch()
    plan = plan_batch(ids, CFG.num_image_tokens, pad_multiple=gc.pad_multiple)
    chunk = tgen.decode_chunk_len(gc)
    n_chunks = -(-gc.max_new_tokens // chunk)
    steps = n_chunks * chunk

    got = gen.generate(ids, pix, seed=3)  # the first call captures
    runner = gen.decode_runner
    assert runner.graphed and runner.graph is not None and runner.capture_ms > 0
    want, eager_calls = _eager_loop(gen, plan, pix, steps, seed=3)
    assert np.array_equal(np.asarray(got).T, want[:gc.max_new_tokens]), mode
    assert gen.decode_runner is runner  # the same key keeps the runner and its graph

    # a second call replays every step: no host sync while a chunk is
    # enqueued; chunk k is read after chunk k+1 is enqueued, as generate does
    def replay_all():
        toks, pending = [], None
        for _ in range(n_chunks):
            torch.cuda.set_sync_debug_mode("error")
            try:
                following = runner.run_chunk()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if pending is not None:
                toks.append(pending.tokens())
            pending = following
        toks.append(pending.tokens())
        return np.concatenate(toks)

    with torch.inference_mode():
        state, _ = gen.prefill_from_plan(plan, pix, steps)
        runner.load(state, 3)
        del state
        before = kc.read_counters()
        again, device = kc.device_launches(replay_all)
    assert np.array_equal(again, want), mode
    # replays launch on the card what the eager steps' wrappers launched,
    # and no wrapper is called for them
    assert device == eager_calls, (device, eager_calls)
    assert kc.wrapper_calls(before, kc.read_counters()) == dict.fromkeys(kc.SERVING_KERNELS, 0)
    layers = CFG.text.num_hidden_layers
    assert device["decode_kernel"] == layers * steps
    assert device["q4_mlp_kernel"] == (layers * steps if fused else 0)
