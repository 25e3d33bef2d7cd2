"""The port's continuous batching (``generation/continuous.py``) against the
JAX engine and against the port's own solo runs, on shared (bridged) fp32
weights, tiny config.

Every case of ``tests/test_continuous.py`` runs on both engines (the JAX
runs once, in a module fixture): staggered admission and slot reuse, mixed
image and text requests, oversized requests refused, an int8 KV cache (and
fp8 on the port's side), batched admission of 4 and of 3 (2 + 1), sampled
and greedy requests sharing a batch, an explicit temperature 0, the
speculative engine, its refusal of sampling, and ``prewarm``. Greedy
tokens must equal the JAX engine's and a solo
``Generator.generate(pad_to=prompt_bucket)`` of the port, token for token;
a sampled stream must repeat from the engine's seed. Two faults of the
JAX engine are held absent: the admission cache is ONE cache of ``slots``
rows whatever batch sizes are admitted, and ``prewarm`` leaves no gap in
the request ids.

Then the pieces: ``splice_cache_slot`` byte for byte against the JAX
function (bf16, fp32, int8 with its scales, fp8; a source smaller than the
destination), ``_sample_per_slot`` with a ``top_p = 1`` row whose fp32
cumulative sum ends below 1 beside a ``top_p = 0.9`` row (the port's draws
stay inside the nucleus the JAX formula gives), the slot runners' steps
without a host read, and the three evaluation functions of the JAX
``models/dynamic.py``: ``prefill``'s ``vision_score_override`` (same keep
mask and lengths, logits within atol 1e-4), ``decode_step``'s
``output_text_keep_override`` (same tier lengths every step, logits within
atol 1e-4) and ``forward_nocache_eval`` (same kept lengths, logits within
atol 1e-4, rtol 1e-4), dense and sparse.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import LlavaConfig, SparseConfig
from dynamic_llava_tpu.generation.continuous import ContinuousEngine as JEngine
from dynamic_llava_tpu.generation.generate import GenerationConfig as JGenCfg
from dynamic_llava_tpu.generation.generate import _sample_per_slot as jsample_per_slot
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu.multimodal.fusion import plan_batch
from dynamic_llava_tpu.ops import kv_cache as jkv
from dynamic_llava_tpu_torch.generation import generate as tgen
from dynamic_llava_tpu_torch.generation.continuous import ContinuousEngine as TEngine
from dynamic_llava_tpu_torch.models import dynamic as tdyn
from dynamic_llava_tpu_torch.ops import kv_cache as tkv
from dynamic_llava_tpu_torch.weights import params_from_numpy

from test_torch_config import port_config
from test_torch_decode_graph import no_host_reads

LOGITS_ATOL = 1e-4


def _cfg(**overrides) -> LlavaConfig:
    """``tests/test_continuous.py``'s config: vision and output-text
    predictors on."""
    sparse = SparseConfig(
        d_model=32, nhead=2, dim_feedforward=64, num_layers=1,
        use_vision_predictor=True, use_text_predictor=False,
        use_output_text_predictor=True, use_instruct_predictor=False,
    )
    return LlavaConfig.tiny(sparse=dataclasses.replace(sparse, **overrides))


CFG = _cfg()
TCFG = port_config(CFG)


def _gen(**kw) -> dict:
    return dict(max_new_tokens=kw.pop("max_new_tokens", 16),
                decode_chunk=kw.pop("decode_chunk", 4), pad_multiple=8, **kw)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(3, 200, size=(n,)).astype(np.int64)


def _image():
    size = CFG.vision.image_size
    return np.random.default_rng(7).normal(size=(size, size, 3)).astype(np.float32)


def _image_prompt():
    ids = _prompt(8, 9)
    ids[1] = -200
    return ids


@pytest.fixture(scope="module")
def weights():
    jp = jax.jit(jdyn.init_llava_params, static_argnums=(1,))(jax.random.key(0), CFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


def _maker(side, weights):
    """``make(gen fields, **engine options)`` for one side's engine."""
    jp, tp = weights

    def make(gen=None, **kw):
        g = _gen(**(gen or {}))
        if side == "jax":
            return JEngine(jp, CFG, JGenCfg(**g), **kw)
        return TEngine(tp, TCFG, tgen.GenerationConfig(**g), device="cpu", **kw)
    return make


def _solo(weights, prompt, max_new, bucket, pixels=None, **gen):
    """The port's solo greedy run of one request, padded to the bucket."""
    g = tgen.GenerationConfig(**_gen(max_new_tokens=max_new, **gen))
    return tgen.Generator(weights[1], TCFG, g).generate([prompt], pixels, pad_to=bucket)[0]


# -- the cases of tests/test_continuous.py, each a function of an engine maker.
# Each returns what the two engines must agree on and the solo runs to hold
# it to: (observations, [(request output, solo args)]).

def staggered(make):
    """r0 alone, r1 joins mid-flight, r2 waits for a freed slot."""
    engine = make(slots=2, prompt_bucket=24, max_new_cap=16, with_images=False)
    prompts, max_news = [_prompt(1, 7), _prompt(2, 12), _prompt(3, 19)], [16, 6, 10]
    r0 = engine.submit(prompts[0], max_new_tokens=max_news[0])
    engine.step()
    r1 = engine.submit(prompts[1], max_new_tokens=max_news[1])
    r2 = engine.submit(prompts[2], max_new_tokens=max_news[2])
    waiting = engine._slot_req.count(None)
    engine.run_until_drained()
    rids = (r0, r1, r2)
    obs = dict(waiting=waiting, free=list(engine._slot_req),
               done=[engine.requests[r].done for r in rids])
    return obs, [(engine.requests[r].output, (p, n, 24)) for r, p, n in
                 zip(rids, prompts, max_news)]


def slot_reuse(make):
    """A short request in the slot a longer generation left."""
    engine = make(slots=1, prompt_bucket=24, max_new_cap=16, with_images=False)
    long_req = engine.submit(_prompt(5, 20), max_new_tokens=16)
    engine.run_until_drained()
    short_req = engine.submit(_prompt(6, 4), max_new_tokens=5)
    engine.run_until_drained()
    return {}, [(engine.requests[long_req].output, (_prompt(5, 20), 16, 24)),
                (engine.requests[short_req].output, (_prompt(6, 4), 5, 24))]


def mixed_image_and_text(make):
    engine = make(slots=2, prompt_bucket=24, max_new_cap=8)
    img, ids_img, ids_txt = _image(), _image_prompt(), _prompt(9, 11)
    ri = engine.submit(ids_img, pixel_values=img, max_new_tokens=8)
    rt = engine.submit(ids_txt, max_new_tokens=8)
    engine.run_until_drained()
    return ({}, [(engine.requests[ri].output, (ids_img, 8, 24, img[None])),
                 (engine.requests[rt].output, (ids_txt, 8, 24))])


def kv_cache_of(dtype):
    def case(make):
        engine = make(gen=dict(cache_dtype=dtype), slots=2, prompt_bucket=16, max_new_cap=8,
                      with_images=False)
        p0, p1 = _prompt(11, 6), _prompt(12, 10)
        r0 = engine.submit(p0, max_new_tokens=8)
        engine.step()
        r1 = engine.submit(p1, max_new_tokens=8)
        engine.run_until_drained()
        return {}, [(engine.requests[r].output, (p, 8, 16, None, dict(cache_dtype=dtype)))
                    for r, p in ((r0, p0), (r1, p1))]
    return case


def batched_admission(make):
    """4 requests queued before any step admit as ONE batch of 4."""
    engine = make(slots=4, prompt_bucket=24, max_new_cap=16, with_images=False)
    prompts = [_prompt(20 + i, 5 + 3 * i) for i in range(4)]
    rids = [engine.submit(p, max_new_tokens=8) for p in prompts]
    engine.step()
    sizes = sorted(engine.admitted_batch_sizes)
    engine.run_until_drained()
    return dict(sizes=sizes), [(engine.requests[r].output, (p, 8, 24))
                               for r, p in zip(rids, prompts)]


def batched_admission_non_pow2(make):
    """3 queued requests admit as 2 + 1."""
    engine = make(slots=4, prompt_bucket=24, max_new_cap=16, with_images=False)
    prompts = [_prompt(30 + i, 6 + 2 * i) for i in range(3)]
    rids = [engine.submit(p, max_new_tokens=6) for p in prompts]
    engine.step()
    sizes = sorted(engine.admitted_batch_sizes)
    engine.run_until_drained()
    return dict(sizes=sizes), [(engine.requests[r].output, (p, 6, 24))
                               for r, p in zip(rids, prompts)]


def sampled_and_greedy(make):
    """The greedy row of a batch that also samples (the sampled row's
    tokens are the engine's own draws: held to its seed below)."""
    engine = make(slots=2, prompt_bucket=24, max_new_cap=16, with_images=False)
    rg = engine.submit(_prompt(40, 7), max_new_tokens=10)
    engine.submit(_prompt(41, 9), max_new_tokens=10, temperature=0.9, top_p=0.9)
    engine.run_until_drained()
    return {}, [(engine.requests[rg].output, (_prompt(40, 7), 10, 24))]


def explicit_temperature_zero(make):
    engine = make(slots=1, prompt_bucket=16, max_new_cap=8, with_images=False)
    p = _prompt(50, 6)
    rid = engine.submit(p, max_new_tokens=8, temperature=0.0, top_p=0.9)
    engine.run_until_drained()
    return {}, [(engine.requests[rid].output, (p, 8, 16))]


def speculative(make):
    """The spec_k engine, staggered admission and slot reuse."""
    prompts, max_news = [_prompt(60, 7), _prompt(61, 12), _prompt(62, 16)], [16, 8, 12]
    engine = make(slots=2, prompt_bucket=24, max_new_cap=16, with_images=False, spec_k=3)
    r0 = engine.submit(prompts[0], max_new_tokens=max_news[0])
    engine.step()
    r1 = engine.submit(prompts[1], max_new_tokens=max_news[1])
    r2 = engine.submit(prompts[2], max_new_tokens=max_news[2])
    engine.run_until_drained()
    return {}, [(engine.requests[r].output, (p, n, 24))
                for r, p, n in zip((r0, r1, r2), prompts, max_news)]


def after_prewarm(make):
    """Real traffic after ``prewarm``: a clean engine, then the staggered
    requests of the first case."""
    engine = make(slots=2, prompt_bucket=24, max_new_cap=16, with_images=False)
    engine.prewarm(_prompt(80, 9))
    clean = dict(requests=dict(engine.requests), slots=list(engine._slot_req),
                 queue=list(engine._queue), inflight=list(engine._inflight))
    prompts, max_news = [_prompt(81, 7), _prompt(82, 12), _prompt(83, 19)], [16, 6, 10]
    rids = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts, max_news)]
    engine.run_until_drained()
    return dict(clean=clean), [(engine.requests[r].output, (p, n, 24))
                               for r, p, n in zip(rids, prompts, max_news)]


CASES = {
    "staggered admission": staggered,
    "slot reuse": slot_reuse,
    "mixed image and text": mixed_image_and_text,
    "int8 KV cache": kv_cache_of("int8"),
    "batched admission": batched_admission,
    "batched admission 2 + 1": batched_admission_non_pow2,
    "sampled and greedy": sampled_and_greedy,
    "explicit temperature 0": explicit_temperature_zero,
    "speculative": speculative,
    "after prewarm": after_prewarm,
}
# the port's alone: the JAX package's tests run no fp8 engine
PORT_ONLY = {"fp8 KV cache": kv_cache_of("float8_e4m3fn")}


@pytest.fixture(scope="module")
def jax_runs(weights):
    make = _maker("jax", weights)
    return {name: case(make) for name, case in CASES.items()}


@pytest.mark.parametrize("name", list(CASES) + list(PORT_ONLY))
def test_engine_matches_jax_and_solo(weights, jax_runs, name):
    obs, runs = {**CASES, **PORT_ONLY}[name](_maker("torch", weights))
    if name in CASES:
        want_obs, want_runs = jax_runs[name]
        assert [out for out, _ in runs] == [out for out, _ in want_runs]
        if name != "after prewarm":  # the JAX prewarm's leftovers are not the point here
            assert obs == want_obs
    for out, (prompt, max_new, bucket, *rest) in runs:
        pixels = rest[0] if rest else None
        gen = rest[1] if len(rest) > 1 else {}
        assert out == _solo(weights, prompt, max_new, bucket, pixels, **gen), name
        assert 1 <= len(out) <= max_new
    if name == "staggered admission":
        assert obs == dict(waiting=1, free=[None, None], done=[True] * 3)
    if name.startswith("batched"):
        assert obs["sizes"] == ([4] if name == "batched admission" else [1, 2])
    if name == "after prewarm":
        assert obs["clean"] == dict(requests={}, slots=[None, None], queue=[], inflight=[])


def test_speculative_engine_equals_the_plain_engine(weights):
    """The speculative case's traffic through the plain engine: the same
    tokens (accepted drafts change the rounds, never the tokens)."""
    make = _maker("torch", weights)
    spec = [out for out, _ in speculative(make)[1]]
    plain = [out for out, _ in speculative(lambda **kw: make(**{**kw, "spec_k": 0}))[1]]
    assert spec == plain


def test_sampled_stream_repeats_from_the_seed(weights):
    """Same seed, same submissions: the same sampled tokens; the greedy
    row is untouched by the sampling beside it."""
    make = _maker("torch", weights)

    def run():
        engine = make(slots=2, prompt_bucket=24, max_new_cap=16, with_images=False)
        rg = engine.submit(_prompt(40, 7), max_new_tokens=10)
        rs = engine.submit(_prompt(41, 9), max_new_tokens=10, temperature=0.9, top_p=0.9)
        engine.run_until_drained()
        return engine.requests[rg].output, engine.requests[rs].output

    greedy, sampled = run()
    assert 1 <= len(sampled) <= 10 and all(0 <= t < CFG.text.vocab_size for t in sampled)
    assert run() == (greedy, sampled)
    assert greedy == _solo(weights, _prompt(40, 7), 10, 24)


def test_the_sampling_form_runs_only_while_a_slot_samples(weights, monkeypatch):
    """A chunk runs the sampling form only while a slot's temperature is
    above 0; a freed slot goes back to greedy (the JAX freed-slot reset)."""
    engine = _maker("torch", weights)(slots=2, prompt_bucket=24, max_new_cap=16,
                                      with_images=False)
    forms = []
    real = engine.runner.run_chunk

    def spy(sampled=False):
        forms.append(sampled)
        return real(sampled)

    monkeypatch.setattr(engine.runner, "run_chunk", spy)
    engine.submit(_prompt(42, 8), max_new_tokens=4, temperature=0.7, top_p=0.8)
    engine.submit(_prompt(43, 8), max_new_tokens=16)
    engine.run_until_drained()
    assert forms[0] is True and forms[-1] is False, forms
    assert engine.runner.temps.tolist() == [0.0, 0.0]
    assert engine.runner.top_ps.tolist() == [1.0, 1.0]
    assert not engine._temps.any()


def test_spec_mode_refuses_sampling(weights):
    for side in ("jax", "torch"):
        make = _maker(side, weights)
        engine = make(slots=1, prompt_bucket=16, max_new_cap=8, with_images=False, spec_k=2)
        with pytest.raises(ValueError):
            engine.submit(_prompt(70, 5), max_new_tokens=8, temperature=0.7)
    with pytest.raises(AssertionError):
        _maker("jax", weights)(gen=dict(temperature=0.8), slots=1, prompt_bucket=16,
                               max_new_cap=8, with_images=False, spec_k=2)
    with pytest.raises(ValueError, match="greedy"):
        _maker("torch", weights)(gen=dict(temperature=0.8), slots=1, prompt_bucket=16,
                                 max_new_cap=8, with_images=False, spec_k=2)


def test_oversized_requests_are_refused(weights):
    for side in ("jax", "torch"):
        engine = _maker(side, weights)(slots=1, prompt_bucket=16, max_new_cap=8,
                                       with_images=False)
        with pytest.raises(ValueError):
            engine.submit(_prompt(1, 17))
        with pytest.raises(ValueError):
            engine.submit(_prompt(1, 8), max_new_tokens=64)
    # the port also refuses an image prompt whose fused length passes the
    # bucket (the JAX engine fails in its planner at admission)
    engine = _maker("torch", weights)(slots=1, prompt_bucket=16, max_new_cap=8)
    ids = _prompt(1, 16 - CFG.num_image_tokens + 2)
    ids[1] = -200
    with pytest.raises(ValueError, match="fused"):
        engine.submit(ids, pixel_values=_image(), max_new_tokens=4)
    assert engine.requests == {}


def test_the_admission_cache_is_one_cache_of_slots_rows(weights):
    """Admissions of 1, 2 and 4 requests prefill into rows of ONE cache of
    ``slots`` rows, made once (the JAX engine keeps one a batch size)."""
    engine = _maker("torch", weights)(slots=4, prompt_bucket=24, max_new_cap=16,
                                      with_images=False)
    assert engine.admission_cache is None
    caches, outs = [], []
    for k in (1, 2, 4):
        prompts = [_prompt(90 + 10 * k + i, 5 + i) for i in range(k)]
        rids = [engine.submit(p, max_new_tokens=6) for p in prompts]
        engine.run_until_drained()
        caches.append(engine.admission_cache)
        outs += [(engine.requests[r].output, p) for r, p in zip(rids, prompts)]
    assert engine.admitted_batch_sizes == {1, 2, 4}
    assert all(c is caches[0] for c in caches)
    for tier, cap in zip(caches[0], (engine.admit_pre_cap, engine.admit_post_cap)):
        assert tier.k.shape[1] == tier.v.shape[1] == tier.length.shape[1] == 4
        assert tier.k.shape[2] == cap
    for out, p in outs:
        assert out == _solo(weights, p, 6, 24)


def test_prewarm_leaves_no_gap_in_the_request_ids(weights):
    """``prewarm`` drops exactly the records of the requests it submitted:
    the ids of the ladder (1 + 2) and the saturated pass (2 x slots) are 0
    ... 6, and the next request gets 7 (the JAX prewarm takes two ids for
    its bookkeeping)."""
    engine = _maker("torch", weights)(slots=2, prompt_bucket=24, max_new_cap=16,
                                      with_images=False)
    before = engine.submit(_prompt(84, 5), max_new_tokens=4)
    engine.run_until_drained()
    engine.prewarm(_prompt(80, 9))
    assert list(engine.requests) == [before]
    assert engine.submit(_prompt(85, 6), max_new_tokens=4) == before + 1 + (1 + 2) + 2 * 2
    # the sampling form was captured too (one prewarm request samples)
    assert engine.runner.generator is not None


# -- splice_cache_slot ---------------------------------------------------------

STORAGE = ["bfloat16", "float32", "int8", "float8_e4m3fn"]


def _cache_pair(rng, dtype, batch, max_len, layers=2, heads=2, d=4):
    """The same random cache bits in a JAX and a port ``KVCache``."""
    shape = (layers, batch, max_len, heads, d)

    def bits(shape, kind):
        if kind == "float32":
            a = rng.normal(size=shape).astype(np.float32)
            return jnp.asarray(a), torch.from_numpy(a.copy())
        if kind == "bfloat16":  # finite values (XLA may rewrite a NaN's payload)
            a = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
                torch.bfloat16).view(torch.int16).numpy()
            return (jnp.asarray(a.view(np.uint16)).view(jnp.bfloat16),
                    torch.from_numpy(a.copy()).view(torch.bfloat16))
        a = rng.integers(0, 2**8, size=shape).astype(np.uint8)
        a = np.where(a & 0x7F == 0x7F, a ^ 1, a).astype(np.uint8)  # no fp8 NaN
        if kind == "int8":
            return jnp.asarray(a.view(np.int8)), torch.from_numpy(a.view(np.int8).copy())
        return (jnp.asarray(a).view(jnp.float8_e4m3fn),
                torch.from_numpy(a.copy()).view(torch.float8_e4m3fn))

    (jk, tk), (jv, tv) = bits(shape, dtype), bits(shape, dtype)
    lens = rng.integers(0, max_len, size=(layers, batch)).astype(np.int32)
    fields_j, fields_t = dict(k=jk, v=jv, length=jnp.asarray(lens)), dict(
        k=tk, v=tv, length=torch.from_numpy(lens.copy()))
    if dtype == "int8":
        (jks, tks), (jvs, tvs) = bits(shape[:-1], "bfloat16"), bits(shape[:-1], "bfloat16")
        fields_j.update(k_scale=jks, v_scale=jvs)
        fields_t.update(k_scale=tks, v_scale=tvs)
    return jkv.KVCache(**fields_j), tkv.KVCache(**fields_t)


def _bytes_np(x):
    """The bytes of a JAX array or a tensor (bf16 and fp8 through an
    integer view)."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            x = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.uint8)
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


@pytest.mark.parametrize("dtype", STORAGE)
def test_splice_cache_slot_matches_jax_byte_for_byte(dtype):
    """Row 1 of a batch-3 source of 5 slots into slot 2 of a batch-4
    destination of 9 slots: the JAX splice of the source's row (a batch-1
    view, as the JAX engine's ``_row_state``) and the port's in-place one
    leave the same bytes; slots past the source's capacity keep theirs."""
    rng = np.random.default_rng(STORAGE.index(dtype))
    jdst, tdst = _cache_pair(rng, dtype, batch=4, max_len=9)
    jsrc, tsrc = _cache_pair(rng, dtype, batch=3, max_len=5)
    row = jsrc._replace(**{f: getattr(jsrc, f)[:, 1:2] for f in jsrc._fields
                           if getattr(jsrc, f) is not None})
    want = jkv.splice_cache_slot(jdst, row, 2)
    stale = tdst.k[:, 2, 5:].clone()
    tkv.splice_cache_slot(tdst, tsrc, 2, row=1)
    for f in tdst._fields:
        if getattr(tdst, f) is not None:
            assert np.array_equal(_bytes_np(getattr(tdst, f)), _bytes_np(getattr(want, f))), f
    assert np.array_equal(_bytes_np(tdst.k[:, 2, 5:]), _bytes_np(stale))


def test_splice_refuses_what_does_not_fit():
    rng = np.random.default_rng(9)
    _, small = _cache_pair(rng, "float32", batch=2, max_len=4)
    _, big = _cache_pair(rng, "float32", batch=2, max_len=6)
    _, other = _cache_pair(rng, "int8", batch=2, max_len=4)
    with pytest.raises(ValueError, match="does not fit"):
        tkv.splice_cache_slot(small, big, 0)
    with pytest.raises(ValueError, match="storage"):
        tkv.splice_cache_slot(big, other, 0)


def test_splice_tiered_slot_carries_the_whole_state():
    """``DecodeRunner.splice_row``: both tiers, ``next_pos`` and
    ``last_logits`` of one row land in one slot, other slots untouched."""
    jp = jax.jit(jdyn.init_llava_params, static_argnums=(1,))(jax.random.key(1), CFG)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    g = tgen.GenerationConfig(**_gen(cache_dtype="float32"))
    key = tgen.runner_key(3, (40, 40), stop=((2,),), chunk=4)
    runner = tgen.SlotDecodeRunner(tp, TCFG, g, key, "cpu")
    plan = plan_batch([_prompt(1, 7), _prompt(2, 9)], 0, pad_to=16)
    cache = tdyn.make_gen_cache(TCFG, 2, 16, 0, torch.float32, all_have_image=False,
                                device="cpu")
    state, _ = tgen.Generator(tp, TCFG, g).prefill_into(plan, None, cache)
    before = [t.clone() for t in (runner.state.next_pos, runner.state.last_logits)]
    runner.splice_row(state, 1, 2)
    st = runner.state
    assert st.next_pos.tolist() == [0, 0, int(plan.valid_len[1])]
    assert torch.equal(st.last_logits[2], state.last_logits[1])
    assert torch.equal(st.last_logits[:2], before[1][:2])
    for got, src in zip(st.cache, state.cache):
        n = src.max_len
        assert torch.equal(got.k[:, 2, :n], src.k[:, 1]) and torch.equal(got.length[:, 2],
                                                                           src.length[:, 1])


# -- _sample_per_slot --------------------------------------------------------------


def _row_below_one(v=1000):
    """Logits whose fp32 cumulative sum of sorted probabilities ends below
    1 in both packages: a ``top_p = 1`` row there has no cutoff index."""
    for seed in range(200):
        lg = np.random.default_rng(seed).normal(size=(v,)).astype(np.float32)
        t = torch.from_numpy(lg)
        tc = torch.cumsum(torch.softmax(torch.sort(t, descending=True).values, -1), -1)
        jc = jnp.cumsum(jax.nn.softmax(jnp.sort(jnp.asarray(lg))[::-1]))
        if float(tc[-1]) < 1.0 and float(jc[-1]) < 1.0:
            return lg
    raise AssertionError("no seed gives a cumulative sum below 1")


def _jax_nucleus(logits, temps, top_ps):
    """Each row's kept tokens by the JAX ``_sample_per_slot`` formula (its
    mask, written out: ``take_along_axis`` at index V gives NaN, and then
    nothing is masked)."""
    lg = jnp.asarray(logits) / jnp.maximum(jnp.asarray(temps), 1e-6)[:, None]
    sl = jnp.sort(lg, axis=-1)[:, ::-1]
    cum = jnp.cumsum(jax.nn.softmax(sl, axis=-1), axis=-1)
    idx = jnp.sum(cum < jnp.asarray(top_ps)[:, None], axis=-1, keepdims=True)
    cutoff = jnp.take_along_axis(sl, idx, axis=-1)
    return np.asarray(~(lg < cutoff)), np.asarray(idx[:, 0])


def test_sample_per_slot_with_a_top_p_1_row():
    v = 1000
    below = _row_below_one(v)
    rng = np.random.default_rng(1)
    logits = np.stack([rng.normal(size=v), below, 3 * rng.normal(size=v),
                       rng.normal(size=v)]).astype(np.float32)
    temps = np.array([0.0, 1.0, 0.8, 0.5], np.float32)
    top_ps = np.array([0.9, 1.0, 0.9, 1.0], np.float32)
    kept, idx = _jax_nucleus(logits, temps, top_ps)
    assert idx[1] == v and kept[1].all()  # the row with no cutoff index
    assert 1 <= kept[2].sum() < v
    gen = torch.Generator().manual_seed(0)
    args = [torch.from_numpy(a) for a in (logits, temps, top_ps)]
    draws = np.stack([tgen._sample_per_slot(gen, *args).numpy() for _ in range(300)])
    assert (draws[:, 0] == np.argmax(logits[0])).all()  # temperature 0: the argmax
    for r in (1, 2, 3):
        assert kept[r][draws[:, r]].all(), r
    assert len(set(draws[:, 1])) > 50  # the unmasked row spreads
    # the JAX function's own draws lie in the same nucleus
    for s in range(20):
        jd = np.asarray(jsample_per_slot(jax.random.key(s), jnp.asarray(logits),
                                         jnp.asarray(temps), jnp.asarray(top_ps)))
        assert jd[0] == np.argmax(logits[0]) and all(kept[r][jd[r]] for r in (1, 2, 3))
    # the same draws from the same seed
    gen2 = torch.Generator().manual_seed(0)
    again = np.stack([tgen._sample_per_slot(gen2, *args).numpy() for _ in range(300)])
    assert np.array_equal(draws, again)


# -- the slot runners without a host read -------------------------------------------


@pytest.mark.parametrize("form", ["greedy", "sampling", "speculative"])
def test_slot_runner_step_makes_no_host_read(weights, form):
    _, tp = weights
    g = tgen.GenerationConfig(**_gen())
    if form == "speculative":
        key = tgen.runner_key(2, (48, 48), chunk=2)._replace(m=3, ctx_cap=40, draft=(3, 1))
        runner = tgen.SlotSpecRunner(tp, TCFG, g, key, "cpu")
        runner.admit(1, 6, torch.arange(3, 11, dtype=torch.int32), 8)
    else:
        key = tgen.runner_key(2, (48, 48), stop=((2,),), chunk=2)
        runner = tgen.SlotDecodeRunner(tp, TCFG, g, key, "cpu")
        runner.admit(1, 6, 0.7 if form == "sampling" else 0.0, 0.9)
        runner.sampled = form == "sampling"
    with torch.inference_mode(), no_host_reads():
        runner.step()
        runner.step()
    toks, emitted, active = runner.read(runner.run_chunk())
    rows = 2 * (3 if form == "speculative" else 1)
    assert toks.shape == emitted.shape == (rows, 2) and active.shape == (2,)
    assert not emitted[:, 0].any() and emitted[:, 1].any()  # slot 0 was never admitted


# -- the evaluation functions of models/dynamic.py ----------------------------------


def _plan_args(plan, lib):
    if lib == "jax":
        f = jnp.asarray
    else:
        def f(a):
            return torch.as_tensor(np.asarray(a))
    return (f(plan.token_ids), f(plan.is_image), f(plan.image_slot), f(plan.valid_len),
            f(plan.spans.image_start), f(plan.spans.last_instruct_start),
            f(plan.spans.last_instruct_end), f(plan.spans.has_image))


def _image_batch(cfg, b=2):
    rng = np.random.default_rng(5)
    ids = []
    for i in range(b):
        x = rng.integers(3, cfg.text.vocab_size, size=(10 + 3 * i,)).astype(np.int64)
        x[2] = -200
        ids.append(x)
    size = cfg.vision.image_size
    return ids, rng.normal(size=(b, size, size, 3)).astype(np.float32)


def _both_prefill(weights, cfg, override=None, max_new=8):
    jp, tp = weights
    ids, pix = _image_batch(cfg)
    plan = plan_batch(ids, cfg.num_image_tokens)
    jcache = jdyn.make_gen_cache(cfg, plan.batch, plan.seq_len, max_new, jnp.float32)
    tcache = tdyn.make_gen_cache(port_config(cfg), plan.batch, plan.seq_len, max_new,
                                 torch.float32, device="cpu")
    jstate, jinfo = jdyn.prefill(
        jp, cfg, *_plan_args(plan, "jax"), jnp.asarray(pix), jcache, all_have_image=True,
        vision_score_override=None if override is None else jnp.asarray(override))
    tstate, tinfo = tdyn.prefill(
        tp, port_config(cfg), *_plan_args(plan, "torch"), torch.from_numpy(pix), tcache,
        all_have_image=True,
        vision_score_override=None if override is None else torch.from_numpy(override))
    return (jstate, jinfo), (tstate, tinfo)


def test_vision_score_override_matches_jax(weights):
    """Random scores in place of the vision predictor's: the same keep mask,
    kept positions and lengths as the JAX prefill, logits within atol 1e-4;
    and a keep mask other than the learned scores' (the hook is live)."""
    override = np.random.default_rng(11).normal(
        size=(2, CFG.num_image_tokens)).astype(np.float32)
    (js, ji), (ts, ti) = _both_prefill(weights, CFG, override)
    assert np.array_equal(ti.image_keep_mask.numpy(), np.asarray(ji.image_keep_mask))
    assert np.array_equal(ti.kept_positions.numpy(), np.asarray(ji.kept_positions))
    assert np.array_equal(ti.new_length.numpy(), np.asarray(ji.new_length))
    np.testing.assert_allclose(ts.last_logits.numpy(), np.asarray(js.last_logits),
                               atol=LOGITS_ATOL, rtol=LOGITS_ATOL)
    _, (_, learned) = _both_prefill(weights, CFG)
    assert not torch.equal(learned.image_keep_mask, ti.image_keep_mask)


def test_output_text_keep_override_matches_jax(weights):
    """Bernoulli draws in place of the output-text predictor's decision for
    12 greedy steps: the tier lengths equal the JAX decode_step's every
    step and follow the draws, logits within atol 1e-4."""
    jp, tp = weights
    (js, _), (ts, _) = _both_prefill(weights, CFG, max_new=12)
    draws = np.random.default_rng(12).random((12, 2)) < 0.5
    post0 = ts.cache.post.length.numpy()[0].copy()
    jstep = jax.jit(jdyn.decode_step, static_argnums=(1,))
    for keep in draws:
        jtok = jnp.argmax(js.last_logits, axis=-1)
        ttok = torch.argmax(ts.last_logits, dim=-1)
        assert np.array_equal(ttok.numpy(), np.asarray(jtok))
        js = jstep(jp, CFG, jtok, js, output_text_keep_override=jnp.asarray(keep))
        ts = tdyn.decode_step(tp, TCFG, ttok, ts,
                              output_text_keep_override=torch.from_numpy(keep))
        for tier in ("pre", "post"):
            assert np.array_equal(getattr(ts.cache, tier).length.numpy(),
                                  np.asarray(getattr(js.cache, tier).length))
        np.testing.assert_allclose(ts.last_logits.numpy(), np.asarray(js.last_logits),
                                   atol=LOGITS_ATOL, rtol=LOGITS_ATOL)
    assert np.array_equal(ts.cache.post.length.numpy()[0], post0 + draws.sum(axis=0))


def _nocache_args(plan, lib):
    args = list(_plan_args(plan, lib))
    ans = plan.spans.answer_start
    args.insert(5, jnp.asarray(ans) if lib == "jax" else torch.as_tensor(np.asarray(ans)))
    return args


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_forward_nocache_eval_matches_jax(kind):
    """Text-only dense and an image prompt with its answer as the tail,
    under the vision and output-text predictors: the same kept lengths as
    the JAX function, logits within atol / rtol 1e-4."""
    if kind == "dense":
        cfg = _cfg(use_vision_predictor=False, use_output_text_predictor=False)
    else:
        cfg = _cfg(vision_keep_rate=0.25, use_instruct_predictor=True)
    jp = jax.jit(jdyn.init_llava_params, static_argnums=(1,))(jax.random.key(3), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    rng = np.random.default_rng(3)
    if kind == "dense":
        ids = list(rng.integers(3, cfg.text.vocab_size, size=(2, 11)))
        plan, pix = plan_batch(ids, 0), None
    else:
        ids = rng.integers(3, cfg.text.vocab_size, size=(2, 14)).astype(np.int64)
        ids[:, 2] = -200
        labels = ids.copy()
        labels[:, :9] = -100  # the answer: the tail
        plan = plan_batch(list(ids), cfg.num_image_tokens, labels_list=list(labels))
        size = cfg.vision.image_size
        pix = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    jl, jlen = jdyn.forward_nocache_eval(
        jp, cfg, *_nocache_args(plan, "jax"), None if pix is None else jnp.asarray(pix))
    tl, tlen = tdyn.forward_nocache_eval(
        tp, port_config(cfg), *_nocache_args(plan, "torch"),
        None if pix is None else torch.from_numpy(pix))
    assert np.array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL, rtol=LOGITS_ATOL)
    if kind == "dense":
        assert (tlen.numpy() == 11).all()
    else:
        n_img = cfg.num_image_tokens
        assert (tlen.numpy() <= plan.valid_len - n_img + cfg.sparse.vision_keep_budget(n_img)).all()
