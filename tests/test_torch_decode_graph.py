"""The decode runner of the port's ``Generator`` on the CPU (the card-side
half, graph capture and replay, is ``tests/test_torch_card_graph.py``).

(a) A decode step makes no host read: ``decode_step`` and the runner's step
run under a patch that makes every host read of a tensor (``item``,
``tolist``, ``cpu``, ``numpy``, ``bool`` / ``int`` / ``float`` / ``index``)
and every tensor made from host data (``torch.tensor``) raise, in drop mode
past the post tier's budget, in ring mode past both tiers' wrap, with int8
and fp8 caches, a sliding window and an ``active`` mask. A CUDA graph
capture of such a read would fail or freeze a stale value; this is the
capture-safety guard the CPU can run.
(b) The runner's static buffers after eager steps equal the functional
``decode_step`` loop's state byte for byte (both tiers' K/V and scales,
lengths, ``next_pos``, ``last_logits``), and its token buffer the loop's
tokens.
(c) The runner key changes with every field a captured step depends on
beyond the ``Generator``'s config, ``DYNAMIC_LLAVA_Q4_MLP`` included; a
``Generator`` keeps one runner and replaces it when the key changes.
(d) ``generate`` enqueues chunk k+1 before it reads chunk k (a recording
stand-in around the runner), and with an EOS inside the first chunk its
outputs and ``on_chunk`` calls equal the JAX ``Generator``'s.
(e) The names by which the card's launches of the serving kernels are
counted (``kernel_cases.SERVING_KERNELS``) match those kernels' names as
the compiler emits them and as the profiler demangles them, and no other.
(f) The stopping runner of the chat (``StopDecodeRunner``): its step makes
no host read (under the same patch), and after three chunks in which one
sample meets a two-token stop sequence in mid-chunk, one meets EOS and one
runs to the limit, its tokens, emitted flags, end-of-chunk ``active`` and
every static buffer equal a functional loop of ``decode_step(active=)``
with the stop test written in numpy; frozen samples keep their lengths,
``next_pos`` and ``last_logits``.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

import jax
import torch

from dynamic_llava_tpu.config import LlavaConfig as JLlavaConfig
from dynamic_llava_tpu.generation.generate import GenerationConfig as JGenCfg
from dynamic_llava_tpu.generation.generate import Generator as JGen
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu_torch.config import (
    DENSE_SPARSE_CONFIG, IMAGE_TOKEN_INDEX, LlavaConfig)
from dynamic_llava_tpu_torch.generation import generate as tgen
from dynamic_llava_tpu_torch.generation.generate import GenerationConfig, Generator
from dynamic_llava_tpu_torch.models import dynamic
from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
from dynamic_llava_tpu_torch.weights import init_llava_params, params_from_numpy

from test_torch_config import port_config

SPARSE = LlavaConfig.tiny()
DENSE = LlavaConfig.tiny(sparse=DENSE_SPARSE_CONFIG)
WINDOWED = dataclasses.replace(DENSE, text=dataclasses.replace(DENSE.text, sliding_window=32))
# no capacity rounding and a decode window of 2: 30 steps fill the post tier
# (drop: force-drop) or wrap both tiers (ring)
BASE = dict(max_new_tokens=30, decode_chunk=4, pad_multiple=1, kv_window=2, eos_token_id=-1)
STEPS = 30


@pytest.fixture(scope="module")
def params():
    return init_llava_params(SPARSE, torch.Generator().manual_seed(0), "cpu", torch.float32)


def _batch(seed=0):
    """Two samples with an image and one without (``all_have_image`` False)."""
    rng = np.random.default_rng(seed)
    ids = []
    for i in range(3):
        head, tail = rng.integers(3, 500, 4 + i), rng.integers(3, 500, 6)
        ids.append(np.concatenate([head, [IMAGE_TOKEN_INDEX], tail]) if i != 1
                   else np.concatenate([head, tail]))
    size = SPARSE.vision.image_size
    return ids, rng.normal(size=(3, size, size, 3)).astype(np.float32)


def _plan(cfg, ids, gc):
    return plan_batch(ids, cfg.num_image_tokens, pad_multiple=gc.pad_multiple)


def _raise(name):
    def host_read(*args, **kwargs):
        raise AssertionError(f"host read in a decode step: {name}")
    return host_read


@contextlib.contextmanager
def no_host_reads():
    """Every host read of a tensor, and every tensor made from host data,
    raises inside the block."""
    patched = [(torch.Tensor, n) for n in ("item", "tolist", "cpu", "numpy", "__bool__",
                                           "__int__", "__float__", "__index__")]
    patched.append((torch, "tensor"))
    saved = [(obj, n, obj.__dict__.get(n)) for obj, n in patched]
    try:
        for obj, n in patched:
            setattr(obj, n, _raise(n))
        yield
    finally:
        for obj, n, fn in saved:  # put back what the class or module itself held
            if fn is None:
                delattr(obj, n)
            else:
                setattr(obj, n, fn)


def test_the_guard_sees_host_reads():
    t = torch.ones(2, dtype=torch.int32)
    for read in (lambda: t[0].item(), lambda: t.tolist(), lambda: bool(t[0]),
                 lambda: int(t[0]), lambda: float(t[0]), lambda: t.numpy(),
                 lambda: range(t[0]), lambda: torch.tensor(1.0)):
        with no_host_reads(), pytest.raises(AssertionError, match="host read"):
            read()
    assert t.tolist() == [1, 1] and bool(t[0]) and torch.tensor(2.0).item() == 2.0


MODES = {
    "drop, past the post budget": (SPARSE, {}, False),
    "ring, past both wraps": (SPARSE, dict(kv_overflow="ring"), False),
    "dense ring": (DENSE, dict(kv_overflow="ring"), False),
    "int8 KV": (SPARSE, dict(cache_dtype="int8"), False),
    "fp8 KV": (SPARSE, dict(cache_dtype="float8_e4m3fn"), False),
    "sliding window": (WINDOWED, dict(cache_dtype="int8", kv_window=None), False),
    "active mask, ring": (SPARSE, dict(kv_overflow="ring", cache_dtype="int8"), True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_step_makes_no_host_read(params, mode):
    cfg, over, with_active = MODES[mode]
    gc = GenerationConfig(**dict(BASE, **over))
    gen = Generator(params, cfg, gc)
    ids, pix = _batch()
    plan = _plan(cfg, ids, gc)
    with torch.inference_mode():
        state, _ = gen.prefill_from_plan(plan, pix, STEPS)
        runner = gen.runner(plan, pix, STEPS)
        actives = [torch.tensor([True, s % 4 != 1, s < 20]) for s in range(STEPS)]
        with no_host_reads():
            for s in range(STEPS):
                tok = tgen._sample(None, state.last_logits, 0.0, 1.0)
                state = dynamic.decode_step(params, cfg, tok, state,
                                            actives[s] if with_active else None,
                                            kv_overflow=gc.kv_overflow)
        lengths = gen.cache_lengths(state)
        runner.load(state, 0)
        with no_host_reads():
            for _ in range(gc.decode_chunk):
                runner.step()
    budget_post, budget_pre = state.cache.post.max_len - 1, state.cache.pre.max_len - 1
    if gc.kv_overflow == "ring":  # both tiers counted past their budgets: they wrapped
        assert (lengths[0] > budget_pre).any() and (lengths[-1] > budget_post).any()
    elif cfg.sparse.use_output_text_predictor:  # the post tier filled and force-dropped
        assert (lengths[-1] == budget_post).any()
    if with_active:  # the frozen sample advanced less
        assert lengths[0][1] < lengths[0][0]


RUNNER_MODES = {
    "fp32 drop": (SPARSE, {}),
    "int8 KV": (SPARSE, dict(cache_dtype="int8")),
    "fp8 KV": (SPARSE, dict(cache_dtype="float8_e4m3fn")),
    "int8 KV ring, dense": (DENSE, dict(cache_dtype="int8", kv_overflow="ring")),
    "sampling": (SPARSE, dict(temperature=0.8, top_p=0.9)),
}


def _raw(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("mode", list(RUNNER_MODES))
def test_runner_buffers_equal_the_functional_loop(params, mode):
    """Two chunks of the runner against a loop of ``_sample`` +
    ``decode_step`` from the same prefill: every buffer equal byte for byte,
    and the token buffer holds the loop's tokens of the last chunk."""
    cfg, over = RUNNER_MODES[mode]
    gc = GenerationConfig(**dict(BASE, **over))
    ids, pix = _batch()
    plan = _plan(cfg, ids, gc)
    chunk, n = gc.decode_chunk, 2 * gc.decode_chunk
    with torch.inference_mode():
        gen = Generator(params, cfg, gc)
        state, _ = gen.prefill_from_plan(plan, pix, n)
        runner = gen.runner(plan, pix, n)
        runner.load(state, seed=5)
        got = [runner.run_chunk().tokens() for _ in range(2)]
        # the functional loop, on another Generator's buffers
        other = Generator(params, cfg, gc)
        ref, _ = other.prefill_from_plan(plan, pix, n)
        sampler = None if gc.temperature <= 0 else torch.Generator().manual_seed(5)
        toks = []
        for _ in range(n):
            tok = tgen._sample(sampler, ref.last_logits, gc.temperature, gc.top_p)
            ref = dynamic.decode_step(params, cfg, tok, ref, kv_overflow=gc.kv_overflow)
            toks.append(tok)
    toks = torch.stack(toks).to(torch.int32)
    np.testing.assert_array_equal(np.concatenate(got), toks.numpy())
    assert torch.equal(runner.toks, toks[chunk:])
    st = runner.state
    for tier, ref_tier in zip(st.cache, ref.cache):
        for name, a, b in zip(tier._fields, tier, ref_tier):
            assert (a is None) == (b is None), name
            if a is not None:
                assert torch.equal(_raw(a), _raw(b)), name
    assert torch.equal(st.next_pos, ref.next_pos)
    assert torch.equal(_raw(st.last_logits), _raw(ref.last_logits))
    if gc.kv_overflow == "ring":
        assert torch.equal(st.ring_base, ref.ring_base)
        assert torch.equal(st.ring_base_pre, ref.ring_base_pre)


def test_runner_key_changes_with_every_field(params, monkeypatch):
    monkeypatch.delenv("DYNAMIC_LLAVA_Q4_MLP", raising=False)
    base = tgen.runner_key(3, (40, 24))
    variants = [tgen.runner_key(4, (40, 24)), tgen.runner_key(3, (48, 24)),
                tgen.runner_key(3, (40, 32))]
    monkeypatch.setenv("DYNAMIC_LLAVA_Q4_MLP", "1")
    variants.append(tgen.runner_key(3, (40, 24)))
    changed = [[f for f in base._fields if getattr(v, f) != getattr(base, f)]
               for v in variants]
    assert changed == [["batch"], ["pre_len"], ["post_len"], ["q4_mlp"]]

    # generate reuses the runner across calls, and replaces it when the switch changes
    monkeypatch.delenv("DYNAMIC_LLAVA_Q4_MLP")
    gen = Generator(params, SPARSE, GenerationConfig(**dict(BASE, max_new_tokens=4)))
    ids, pix = _batch()
    first = gen.generate(ids, pix)
    runner = gen.decode_runner
    assert gen.generate(ids, pix) == first and gen.decode_runner is runner
    monkeypatch.setenv("DYNAMIC_LLAVA_Q4_MLP", "1")
    assert gen.generate(ids, pix) == first  # fp32 weights: the switch changes no math
    assert gen.decode_runner is not runner and gen.decode_runner.key.q4_mlp


def test_generator_keeps_one_runner(params):
    """Prompts of another length bucket or batch replace the runner (and
    its KV cache) instead of adding one; each call's tokens are those of a
    fresh ``Generator``."""
    gc = GenerationConfig(**dict(BASE, max_new_tokens=4, pad_multiple=8))
    gen = Generator(params, SPARSE, gc)
    ids, pix = _batch()
    longer = [np.concatenate([i, np.arange(3, 20)]) for i in ids]
    keys = []
    for batch_ids, batch_pix in ((ids, pix), (longer, pix), (ids[:2], pix[:2]), (ids, pix)):
        got = gen.generate(batch_ids, batch_pix)
        keys.append(gen.decode_runner.key)
        assert got == Generator(params, SPARSE, gc).generate(batch_ids, batch_pix)
        assert [k for k, v in vars(gen).items() if isinstance(v, tgen.DecodeRunner)] == \
            ["decode_runner"]
    assert len(set(keys)) == 3 and keys[0] == keys[3]


def test_a_capture_pauses_the_garbage_collector(params, monkeypatch):
    """A collection inside a capture can free a dead ``CUDAGraph``, and
    destroying a graph invalidates the capture (ROADMAP §C24): the runner
    captures its step with the cyclic collector paused, and restores it
    after, also when the step raises. The capture itself is faked here."""
    import gc as pygc

    class FakeGraph:
        pass

    @contextlib.contextmanager
    def fake_capture(graph):
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    gc = GenerationConfig(**dict(BASE, max_new_tokens=4))
    ids, pix = _batch()
    runner = Generator(params, SPARSE, gc).runner(_plan(SPARSE, ids, gc), pix, 4)
    seen = []
    monkeypatch.setattr(runner, "step", lambda: seen.append(pygc.isenabled()))
    assert pygc.isenabled()
    runner._capture()
    assert seen == [False] and pygc.isenabled() and isinstance(runner.graph, FakeGraph)

    def failing_step():
        raise RuntimeError("the capture failed")

    monkeypatch.setattr(runner, "step", failing_step)
    with pytest.raises(RuntimeError, match="capture failed"):
        runner._capture()
    assert pygc.isenabled()


def test_a_chunk_is_read_before_its_host_buffer_is_reused(params):
    """A chunk's tokens stay readable until the chunk after next is
    enqueued (it takes the same host buffer); reading later raises."""
    gc = GenerationConfig(**BASE)
    gen = Generator(params, SPARSE, gc)
    ids, pix = _batch()
    plan = _plan(SPARSE, ids, gc)
    with torch.inference_mode():
        state, _ = gen.prefill_from_plan(plan, pix, 3 * gc.decode_chunk)
        runner = gen.runner(plan, pix, 3 * gc.decode_chunk)
        runner.load(state, 0)
        first, second = runner.run_chunk(), runner.run_chunk()
        kept = second.tokens()
        runner.run_chunk()
    with pytest.raises(RuntimeError, match="reused"):
        first.tokens()
    np.testing.assert_array_equal(second.tokens(), kept)


class Recording:
    """Stand-in for a ``DecodeRunner``: records when each chunk is enqueued
    and when its tokens are read."""

    def __init__(self, runner, events):
        self.runner, self.events = runner, events

    def __getattr__(self, name):
        return getattr(self.runner, name)

    def run_chunk(self):
        k = sum(e[0] == "enqueue" for e in self.events)
        self.events.append(("enqueue", k))
        pending = self.runner.run_chunk()
        events = self.events

        class Read:
            def tokens(self):
                events.append(("read", k))
                return pending.tokens()
        return Read()


@pytest.fixture(scope="module")
def bridged():
    cfg = JLlavaConfig.tiny()
    jp = jax.jit(jdyn.init_llava_params, static_argnums=(1,))(jax.random.key(0), cfg)
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


@pytest.mark.parametrize("all_stop", [False, True], ids=["eos-in-first-chunk",
                                                          "all-stop-in-first-chunk"])
def test_chunks_are_pipelined_and_match_jax(bridged, monkeypatch, all_stop):
    """Chunk k+1 is enqueued before chunk k is read. Sample 0 meets EOS at
    its 2nd token; with ``all_stop`` a stopping criterion ends the others in
    the first chunk too, so the speculative second chunk is discarded."""
    jcfg, jp, tp = bridged
    gen = dict(max_new_tokens=12, decode_chunk=4, pad_multiple=8, eos_token_id=-1)
    ids, pix = _batch(1)
    free = JGen(jp, jcfg, JGenCfg(**gen)).generate(ids, pix)
    eos = int(free[0][1])
    gen["eos_token_id"] = eos
    stop = (lambda seq: len(seq) >= 3 and int(seq[-1]) in (free[1][2], free[2][2])) \
        if all_stop else None

    def run(generator):
        chunks = []
        out = generator.generate(ids, pix, stopping_criteria=stop,
                                 on_chunk=lambda i, new: chunks.append((i, list(map(int, new)))))
        return out, chunks

    events = []
    real = Generator.runner
    monkeypatch.setattr(Generator, "runner",
                        lambda self, *a: Recording(real(self, *a), events))
    jout, jchunks = run(JGen(jp, jcfg, JGenCfg(**gen)))
    tout, tchunks = run(Generator(tp, port_config(jcfg), GenerationConfig(**gen)))
    assert tout == jout and tchunks == jchunks
    assert tout[0] == free[0][:2]
    n_chunks = 3
    if all_stop:
        assert all(len(o) <= 4 for o in tout)
        assert events == [("enqueue", 0), ("enqueue", 1), ("read", 0)]
    else:
        assert events == [("enqueue", 0), ("enqueue", 1), ("read", 0), ("enqueue", 2),
                          ("read", 1), ("read", 2)]
        assert len(tout[1]) == len(tout[2]) == 12
    assert sum(e[0] == "enqueue" for e in events) <= n_chunks


STOP_MODES = {
    "drop": (SPARSE, {}),
    "int8 KV": (SPARSE, dict(cache_dtype="int8")),
    "dense fp8 KV": (DENSE, dict(cache_dtype="float8_e4m3fn")),
}


def _stop_reference(params, cfg, gc, plan, pix, steps, stops, limit):
    """The functional loop: greedy ``decode_step(active=)`` on another
    ``Generator``'s buffers, with the stop test in numpy. Returns (state,
    tokens [steps, B], emitted [steps, B], active [B])."""
    gen = Generator(params, cfg, gc)
    state, _ = gen.prefill_from_plan(plan, pix, steps)
    b = plan.batch
    k = max(len(seq) for seq in stops)
    hist = np.full((b, k), -1, np.int64)
    active = np.ones(b, bool)
    n_emit = np.zeros(b, np.int64)
    toks, emitted = [], []
    for _ in range(steps):
        tok = torch.argmax(state.last_logits, dim=-1)
        state = dynamic.decode_step(params, cfg, tok, state,
                                    active=torch.from_numpy(active.copy()),
                                    kv_overflow=gc.kv_overflow)
        t = tok.numpy()
        toks.append(t)
        emitted.append(active.copy())
        nxt = np.concatenate([hist[:, 1:], t[:, None]], axis=1)
        hit = np.array([any(list(nxt[i, k - len(seq):]) == list(seq) for seq in stops)
                        for i in range(b)])
        n_emit += active
        hist = np.where(active[:, None], nxt, hist)
        active = active & ~hit & (n_emit < limit)
    return state, np.stack(toks), np.stack(emitted), active


@pytest.mark.parametrize("mode", list(STOP_MODES))
def test_stop_runner_matches_the_functional_loop(params, mode):
    cfg, over = STOP_MODES[mode]
    gc = GenerationConfig(**dict(BASE, **over))
    ids, pix = _batch(1)
    plan = _plan(cfg, ids, gc)
    chunk, steps, limit = gc.decode_chunk, 3 * gc.decode_chunk, 10
    with torch.inference_mode():
        free = [list(map(int, o)) for o in Generator(params, cfg, gc).generate(ids, pix)]
        # sample 0 meets a two-token sequence at its 2nd token (mid-chunk),
        # sample 1 EOS at its 9th (in the third chunk), sample 2 the limit
        stops = ((free[1][8],), tuple(free[0][:2]))
        assert stops[0][0] not in free[1][:8] + free[2][:limit]
        assert all(tuple(o[i:i + 2]) != stops[1] for o in free[1:] for i in range(limit))
        gen = Generator(params, cfg, gc)
        sizes = gen.cache_sizes(plan, pix, steps)
        key = tgen.runner_key(plan.batch, sizes, stop=stops, chunk=chunk)
        runner = tgen.StopDecodeRunner(params, cfg, gc, key, "cpu")
        state, _ = gen.prefill_into(plan, pix, runner.fresh_cache())
        runner.load(state, 0)
        runner.begin(limit, 0)
        with no_host_reads():
            runner.step()  # the stop test in a step reads nothing on the host
        runner.load(state, 0)
        runner.begin(limit, 0)
        got = [runner.read(runner.run_chunk()) for _ in range(3)]
        ref, toks, emitted, active = _stop_reference(params, cfg, gc, plan, pix, steps, stops,
                                                     limit)
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]), toks)
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got]), emitted)
    np.testing.assert_array_equal(got[-1][2], active)
    assert emitted.sum(0).tolist() == [2, 9, limit]  # where each sample stopped
    assert got[0][2].tolist() == [False, True, True]  # sample 0 frozen in chunk 1
    st = runner.state
    for tier, ref_tier in zip(st.cache, ref.cache):
        for name, a, b in zip(tier._fields, tier, ref_tier):
            if a is not None:
                assert torch.equal(_raw(a), _raw(b)), name
    assert torch.equal(st.next_pos, ref.next_pos)
    assert torch.equal(_raw(st.last_logits), _raw(ref.last_logits))
    # frozen samples advanced exactly by their emitted tokens
    assert (st.next_pos - torch.from_numpy(plan.valid_len).to(torch.int32)).tolist() == \
        emitted.sum(0).tolist()
    assert torch.equal(runner.n_emit, torch.from_numpy(emitted.sum(0)).to(torch.int32))


def test_stop_runner_needs_a_stop_sequence(params):
    gc = GenerationConfig(**BASE)
    with pytest.raises(ValueError, match="no stop sequence"):
        tgen.StopDecodeRunner(params, SPARSE, gc, tgen.runner_key(1, (16, 16)), "cpu")


# kernel names as the compiler emits them (mangled) and as c++filt and the
# profiler give them (demangled) -> their SERVING_KERNELS label
KERNEL_NAMES = {
    "_ZN6dllava55_GLOBAL__N__01617414_22_flash_attention_fwd_cu_2c13897920flash_fwd_mma_"
    "kernelILi128EEEvPK13__nv_bfloat16S4_S4_PKiPS2_Pfiiiiiif": "flash_fwd",
    "void dllava::(anonymous namespace)::flash_fwd_kernel<float, 128>(float const*, float "
    "const*, float const*, int const*, float*, float*, int, int, int, int, int, int, float)":
        "flash_fwd",
    "_ZN6dllava52_GLOBAL__N__6c6d5f17_19_decode_attention_cu_69089eeb13decode_kernelINS0_"
    "3Fp8ELi64ELi2EEEvNS0_10DecodeArgsE": "decode_kernel",
    "void dllava::(anonymous namespace)::decode_kernel<__nv_bfloat16, 128, 1>(dllava::"
    "(anonymous namespace)::DecodeArgs)": "decode_kernel",
    "_ZN6dllava52_GLOBAL__N__6c6d5f17_19_decode_attention_cu_69089eeb13decode_kernelIaLi128ELi2EE"
    "EvNS0_10AttendArgsE": "decode_kernel",
    "_ZN6dllava52_GLOBAL__N__6c6d5f17_19_decode_attention_cu_69089eeb13extend_kernelI13__nv_bf"
    "loat16Li128EEEvNS0_10AttendArgsE": "extend_kernel",
    "void dllava::(anonymous namespace)::extend_kernel<signed char, 64>(dllava::(anonymous "
    "namespace)::AttendArgs)": "extend_kernel",
    "_ZN6dllava46_GLOBAL__N__5be8b358_13_quant_gemv_cu_840698e714gemv_tc_kernelILi16ELb0EEEvPK"
    "13__nv_bfloat16NS0_5GroupEiiiiNS_6TcPlanEPfPi": "gemv int8",
    "void dllava::(anonymous namespace)::gemv_tc_kernel<16, false>(__nv_bfloat16 const*, "
    "dllava::(anonymous namespace)::Group, int, int, int, int, dllava::TcPlan, float*, int*)":
        "gemv int8",
    "_ZN6dllava46_GLOBAL__N__5be8b358_13_quant_gemv_cu_840698e714gemv_tc_kernelILi64ELb1EEEvPK"
    "13__nv_bfloat16NS0_5GroupEiiiiNS_6TcPlanEPfPi": "gemv int4",
    "void dllava::(anonymous namespace)::gemv_fma_kernel<8, true>(float const*, dllava::"
    "(anonymous namespace)::Group, int, int, int, int)": "gemv int4",
    "_ZN6dllava45_GLOBAL__N__e42300a8_12_quant_mlp_cu_92fc2fb713q4_mlp_kernelILi16EEEvNS0_"
    "7MlpArgsE": "q4_mlp_kernel",
    "void dllava::(anonymous namespace)::q4_mlp_kernel<32>(dllava::(anonymous namespace)::"
    "MlpArgs)": "q4_mlp_kernel",
    # training kernels and library kernels are not the serving path's
    "void dllava::(anonymous namespace)::flash_policy_fwd_mma_kernel<128>(__nv_bfloat16 "
    "const*, __nv_bfloat16 const*, __nv_bfloat16 const*, float const*, float const*, "
    "__nv_bfloat16*, int, int, int, float, float)": None,
    "_ZN6dllava55_GLOBAL__N__9af03602_22_flash_attention_bwd_cu_a2b78a5623flash_bwd_dq_mma_"
    "kernelILi128EEEvPK13__nv_bfloat16S4_S4_S4_PKfS6_PKiPS2_iiiiif": None,
    "void dllava::(anonymous namespace)::policy_vsum_kernel<__nv_bfloat16, 128>("
    "__nv_bfloat16 const*, float*, int, int)": None,
    "void gemv2T_kernel_val<int, int, __nv_bfloat16, __nv_bfloat16, float, 128, 16, 4, 4, "
    "false, false, cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<__nv_bfloat16 "
    "const>, cublasGemvTensorStridedBatched<__nv_bfloat16 const>, cublasGemvTensorStrided"
    "Batched<__nv_bfloat16>, float> >(float, float)": None,
    "nvjet_tst_128x64_64x8_2x1_v_bz_coopB_TNN": None,
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
    "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, "
    "3ul>)": None,
}


@pytest.mark.parametrize("name", list(KERNEL_NAMES), ids=lambda n: n[:48])
def test_serving_kernel_names(name):
    from dynamic_llava_tpu_torch import kernel_cases as kc

    assert kc.serving_kernel(name) == KERNEL_NAMES[name]


def test_wrapper_calls_group_a_kernel_wrappers():
    from dynamic_llava_tpu_torch import kernel_cases as kc
    from dynamic_llava_tpu_torch.ops import quant_matmul as qm

    before = kc.read_counters()
    after = dict(before)
    after[qm.q8_gemv] += 3
    after[qm.q8_gemv_group] += 2
    after[qm.q4_mlp] += 1
    want = dict.fromkeys(kc.SERVING_KERNELS, 0)
    want.update({"gemv int8": 5, "q4_mlp_kernel": 1})
    assert kc.wrapper_calls(before, after) == want
