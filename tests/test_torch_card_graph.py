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

The chat's stopping runner (``StopDecodeRunner``) at the same width: its
replays run under ``set_sync_debug_mode("error")``, its tokens, emitted
flags and end-of-chunk ``active`` equal an eager loop of ``decode_step``
with ``active`` and the stop test on the host, with a stop in mid-chunk,
and a chunk run with every sample frozen leaves the tier lengths,
``next_pos`` and ``last_logits`` as they were.

The speculative runner (``SpecRunner``) at the same width, with bf16 and
int8 weights and an int8 KV cache: device- and host-drafted generations
give the tokens, tier lengths and ``next_pos`` of an eager loop of
``decode_speculative_step`` with host prompt-lookup drafts, its chunks are
enqueued under ``set_sync_debug_mode("error")``, and its replays launch
K2-M once a layer a round, K2 never.

The continuous-batching engine at the same width in fp32, plain and
speculative: after ``prewarm``, staggered traffic (admissions spliced
between replays, a sampled request beside greedy ones) gives the greedy
tokens of the same engine on the CPU, with every chunk replayed from its
form's graph (greedy or sampling), enqueued without a host sync.

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


def _stop_loop(gen, plan, pix, steps, room, stops, limit):
    """The stopping runner's reference: prefill (tiers with ``room`` new
    tokens, as the runner's), then ``steps`` of greedy ``decode_step(active=)``
    with the stop test on the host. Returns tokens and emitted flags
    ``[steps, B]`` and the final ``active``."""
    with torch.inference_mode():
        state, _ = gen.prefill_from_plan(plan, pix, room)
        b = plan.batch
        hist = [[] for _ in range(b)]
        active = np.ones(b, bool)
        n_emit = np.zeros(b, int)
        toks, emitted = [], []
        for _ in range(steps):
            tok = torch.argmax(state.last_logits, dim=-1)
            state = dynamic.decode_step(gen.params, gen.cfg, tok, state,
                                        active=torch.from_numpy(active.copy()).cuda())
            t = tok.cpu().numpy()
            toks.append(t)
            emitted.append(active.copy())
            hit = np.zeros(b, bool)
            for i in range(b):
                if active[i]:
                    hist[i].append(int(t[i]))
                    hit[i] = any(hist[i][-len(seq):] == list(seq) for seq in stops)
            n_emit += active
            active = active & ~hit & (n_emit < limit)
    return np.stack(toks), np.stack(emitted), active


def test_stop_runner_replays_match_the_eager_loop():
    params = init_llava_params(CFG, torch.Generator(device="cuda").manual_seed(0), "cuda",
                               torch.bfloat16)
    gc = tgen.GenerationConfig(**BASE)
    gen = tgen.Generator(params, CFG, gc)
    ids, pix = _batch()
    plan = plan_batch(ids, CFG.num_image_tokens, pad_multiple=gc.pad_multiple)
    chunk, n_chunks, limit = gc.decode_chunk, 3, 20
    steps = chunk * n_chunks
    free, _ = _eager_loop(gen, plan, pix, steps, seed=0)
    # sample 0 meets the pair of its 2nd and 3rd tokens by its 3rd token (in
    # mid-chunk); another stop from sample 1's second chunk; the rest stop
    # at the limit (in mid-chunk too), so every sample is frozen by the end
    stops = (tuple(int(t) for t in free[1:3, 0]), (int(free[chunk + 2, 1]),))
    want_toks, want_emitted, want_active = _stop_loop(gen, plan, pix, steps, steps + chunk,
                                                      stops, limit)
    assert 0 < want_emitted[:, 0].sum() <= 3 and not want_active.any()

    key = tgen.runner_key(plan.batch, gen.cache_sizes(plan, pix, steps + chunk), stop=stops,
                          chunk=chunk)
    runner = tgen.StopDecodeRunner(params, CFG, gc, key, "cuda")
    with torch.inference_mode():
        state, _ = gen.prefill_into(plan, pix, runner.fresh_cache())
        runner.load(state, 0)
        del state
    runner.begin(limit, 0)
    got, pending = [], None
    for ci in range(n_chunks + 1):  # the last chunk runs with every sample frozen
        if ci == n_chunks:  # the state after chunk n_chunks - 1, in stream order
            st = runner.state
            frozen = [t.clone() for t in (st.cache.pre.length, st.cache.post.length,
                                          st.next_pos, st.last_logits)]
        torch.cuda.set_sync_debug_mode("error")
        try:
            following = runner.run_chunk()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if pending is not None:
            got.append(runner.read(pending))
        pending = following
    got.append(runner.read(pending))
    assert runner.graph is not None
    toks = np.concatenate([g[0] for g in got[:n_chunks]])
    emitted = np.concatenate([g[1] for g in got[:n_chunks]])
    np.testing.assert_array_equal(emitted, want_emitted)
    np.testing.assert_array_equal(np.where(emitted, toks, -1), np.where(want_emitted, want_toks, -1))
    np.testing.assert_array_equal(got[n_chunks - 1][2], want_active)
    assert not got[n_chunks][1].any()  # the frozen chunk emitted nothing ...
    st = runner.state
    for before, after in zip(frozen, (st.cache.pre.length, st.cache.post.length, st.next_pos,
                                      st.last_logits)):
        assert torch.equal(before, after)  # ... and moved nothing


def _spec_loop(gen, plan, pix, m, max_new):
    """The speculative runner's reference: prefill (tiers with ``m`` slots
    of headroom, as the runner's), then rounds of host prompt-lookup drafts
    + ``decode_speculative_step`` until every sample has ``max_new`` tokens.
    Returns the tokens a sample, the tiers' lengths, ``next_pos``, the
    rounds and the serving kernels' wrapper calls of the rounds."""
    from dynamic_llava_tpu_torch.generation.speculative import prompt_lookup_draft

    b = plan.batch
    prompts = [[int(t) for t in plan.token_ids[i][: plan.valid_len[i]]] for i in range(b)]
    out = [[] for _ in range(b)]
    rounds = 0
    with torch.inference_mode():
        state, _ = gen.prefill_from_plan(plan, pix, max_new + m)
        before = kc.read_counters()
        while any(len(o) < max_new for o in out):
            nxt = torch.argmax(state.last_logits, dim=-1).cpu().numpy()
            toks = np.zeros((b, m), np.int64)
            toks[:, 0] = nxt
            for i in range(b):
                d = prompt_lookup_draft(prompts[i] + out[i] + [int(nxt[i])], m - 1)
                toks[i, 1:1 + len(d)] = d
            done = np.array([len(o) >= max_new for o in out])
            state, n_acc, _ = dynamic.decode_speculative_step(
                gen.params, gen.cfg, torch.from_numpy(toks).cuda(), state,
                gen.gen_cfg.eos_token_id, active=torch.from_numpy(~done).cuda())
            n_acc = n_acc.cpu().numpy()
            rounds += 1
            for i in range(b):
                out[i] += [int(t) for t in toks[i, : min(int(n_acc[i]), max_new - len(out[i]))]]
        calls = kc.wrapper_calls(before, kc.read_counters())
        lengths = torch.cat([state.cache.pre.length, state.cache.post.length]).cpu().numpy()
    return out, lengths, state.next_pos.cpu().numpy(), rounds, calls


@pytest.mark.parametrize("mode", ["bf16", "int8", "int8 KV"])
def test_spec_runner_replays_match_the_eager_loop(mode):
    """The speculative runner at the same width, k = 3: a device-drafted
    generation and a host-drafted one give the tokens, tier lengths and
    ``next_pos`` of an eager loop of ``decode_speculative_step`` with host
    prompt-lookup drafts; the device-drafted chunks are enqueued under
    ``set_sync_debug_mode("error")``; the replays launch K2-M once a layer a
    round and K2 never, as many as the eager loop's wrappers a round."""
    bits, _, over = MODES[mode]
    params = init_llava_params(CFG, torch.Generator(device="cuda").manual_seed(0), "cuda",
                               torch.bfloat16)
    if bits:
        quantize_llm_params(params, bits=bits)
    gc = tgen.GenerationConfig(**dict(BASE, **over))
    gen = tgen.Generator(params, CFG, gc)
    ids, pix = _batch()
    plan = plan_batch(ids, CFG.num_image_tokens, pad_multiple=gc.pad_multiple)
    k, new = 3, gc.max_new_tokens
    want, lengths, next_pos, rounds, eager_calls = _spec_loop(gen, plan, pix, k + 1, new)

    def state_of(runner):
        st = runner.state
        return (torch.cat([st.cache.pre.length, st.cache.post.length]).cpu().numpy(),
                st.next_pos.cpu().numpy())

    assert gen.generate_speculative(ids, pix, draft_k=k) == want, mode  # host drafts
    assert all(np.array_equal(a, b) for a, b in zip(state_of(gen.decode_runner),
                                                    (lengths, next_pos)))
    got = gen.generate_speculative_device(ids, pix, draft_k=k)  # captures the device key
    runner = gen.decode_runner
    assert got == want and runner.graph is not None and runner.capture_ms > 0, mode
    assert all(np.array_equal(a, b) for a, b in zip(state_of(runner), (lengths, next_pos)))

    def replay_all():
        n_chunks, pending = 0, None
        while True:
            torch.cuda.set_sync_debug_mode("error")
            try:
                following = runner.run_chunk()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            n_chunks += 1
            if pending is not None and runner.read(pending).done.all():
                return n_chunks
            pending = following

    with torch.inference_mode():
        state, _ = gen.prefill_into(plan, pix, runner.fresh_cache())
        runner.load(state, 0)
        runner.begin(plan, new)
        del state
        before = kc.read_counters()
        n_chunks, device = kc.device_launches(replay_all)
    grid, n_out, device_rounds = runner.results()
    assert [list(grid[i, : n_out[i]]) for i in range(plan.batch)] == want
    assert device_rounds == rounds
    assert kc.wrapper_calls(before, kc.read_counters()) == dict.fromkeys(kc.SERVING_KERNELS, 0)
    layers = CFG.text.num_hidden_layers
    run = n_chunks * runner.chunk
    assert device["extend_kernel"] == layers * run and device["decode_kernel"] == 0, device
    assert device == {label: n * run // rounds for label, n in eager_calls.items()}, \
        (device, eager_calls)


def _to_card(tree):
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_card(v) for v in tree]
    return tree.cuda() if isinstance(tree, torch.Tensor) else tree


def _engine_traffic(engine, sampled):
    """Staggered requests after a prewarm (every graph captured): two with
    an image, two text-only, a slot freed and taken again; the second
    samples when ``sampled``. Returns the requests' outputs in order."""
    ids, pix = _batch()
    rng = np.random.default_rng(4)
    text = [rng.integers(3, 500, 11), rng.integers(3, 500, 17)]
    rids = [engine.submit(ids[0], pix[0], max_new_tokens=24)]
    engine.step()
    rids.append(engine.submit(text[0], max_new_tokens=12,
                              **(dict(temperature=0.8, top_p=0.9) if sampled else {})))
    rids.append(engine.submit(ids[1], pix[1], max_new_tokens=16))
    rids.append(engine.submit(text[1], max_new_tokens=20))
    engine.run_until_drained()
    return [engine.requests[r].output for r in rids]


@pytest.mark.parametrize("spec_k", [0, 3], ids=["plain", "speculative"])
def test_continuous_engine_matches_the_cpu_engine(spec_k):
    """The continuous engine at the same width on fp32 weights and an fp32
    cache, slots=2, chunks of 8: after ``prewarm`` (the plain engine's
    greedy and sampling graphs captured, the speculative engine's one),
    staggered traffic with admissions spliced between replays gives the
    greedy tokens of the same engine on the CPU (the port's plain path),
    the speculative engine those of the plain one; every chunk is enqueued
    under ``set_sync_debug_mode("error")``, no chunk runs eagerly after its
    form's capture, both forms run in the plain engine, and in a trace of
    the traffic the admissions launch K1 and the chunks K2 (plain) or K2-M
    and no K2 (speculative)."""
    from dynamic_llava_tpu_torch.generation.continuous import ContinuousEngine

    params = init_llava_params(CFG, torch.Generator().manual_seed(0), "cpu", torch.float32)
    gc = tgen.GenerationConfig(max_new_tokens=24, decode_chunk=8, pad_multiple=8,
                               cache_dtype="float32")
    opts = dict(slots=2, prompt_bucket=48, max_new_cap=24, spec_k=spec_k)
    ids, pix = _batch()
    sampled = not spec_k

    cpu = ContinuousEngine(params, CFG, gc, device="cpu", **opts)
    want = _engine_traffic(cpu, sampled)
    if spec_k:
        plain = ContinuousEngine(params, CFG, gc, device="cpu", **dict(opts, spec_k=0))
        assert _engine_traffic(plain, False) == want

    card = ContinuousEngine(_to_card(params), CFG, gc, device="cuda", **opts)
    card.prewarm(ids[0], pix[0])
    runner = card.runner
    forms = []
    real = runner.run_chunk

    def checked(**kw):
        forms.append(kw.get("sampled"))
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(**kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    runner.run_chunk = checked
    captured = runner.eager_steps
    got, seen = kc.device_launches(lambda: _engine_traffic(card, sampled))
    assert runner.eager_steps == captured  # every chunk replayed
    greedy = [i for i in range(len(want)) if not (sampled and i == 1)]
    assert [got[i] for i in greedy] == [want[i] for i in greedy]
    assert all(1 <= len(o) for o in got)
    assert seen["flash_fwd"] > 0
    if spec_k:
        assert runner.graph is not None and runner.eager_steps == 1
        assert seen["extend_kernel"] > 0 and seen["decode_kernel"] == 0
    else:
        assert set(runner.graphs) == {False, True} and runner.eager_steps == 2
        assert {True, False} <= set(forms), forms
        assert seen["decode_kernel"] > 0
