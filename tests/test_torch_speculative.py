"""The port's speculative decoding against its own greedy ``generate`` and
against the JAX package on shared (bridged) weights, fp32, tiny config.

The eight cases of ``tests/test_speculative.py``, each also held against
the JAX functions: every ``CASES`` row (dense, sparse with an int8 KV
cache, vision prune with an fp8 cache, an unbounded post tier; ragged B=2)
with random and prompt-lookup drafts, where the port's tokens must equal
its plain greedy tokens and the JAX ``generate_speculative``'s; EOS inside
a round and the stats; the oracle draft's round count,
``ceil(max_new / (k + 1))``; ``device_prompt_lookup`` against
``prompt_lookup_draft`` and the JAX ``device_prompt_lookup`` on the same
context grid; the device loop against greedy and the JAX device loop, with
and without EOS; the refusal of sampling and of the ring mode. Then two the
JAX side has no counterpart for: one ``decode_speculative_step`` with a
partly accepted draft leaves the state of the JAX step (lengths and
``next_pos`` equal, ``last_logits`` within atol 1e-4, n_acc and next_tok
equal), and a round of the speculative runner makes no host read.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import LlavaConfig, SparseConfig
from dynamic_llava_tpu.generation.generate import GenerationConfig as JGenCfg
from dynamic_llava_tpu.generation.generate import Generator as JGen
from dynamic_llava_tpu.generation.speculative import device_prompt_lookup as jlookup
from dynamic_llava_tpu.generation.speculative import prompt_lookup_draft as jdraft
from dynamic_llava_tpu.models import dynamic as jdyn
from dynamic_llava_tpu_torch.generation import speculative
from dynamic_llava_tpu_torch.generation.generate import GenerationConfig as TGenCfg
from dynamic_llava_tpu_torch.generation.generate import Generator as TGen
from dynamic_llava_tpu_torch.generation.speculative import (
    device_prompt_lookup, prompt_lookup_draft)
from dynamic_llava_tpu_torch.models import dynamic as tdyn
from dynamic_llava_tpu_torch.multimodal.fusion import plan_batch
from dynamic_llava_tpu_torch.weights import params_from_numpy

from test_torch_config import port_config
from test_torch_decode_graph import no_host_reads

_jinit = jax.jit(jdyn.init_llava_params, static_argnums=(1,))
LOGITS_ATOL = 1e-4


def _cfg(**sparse_overrides) -> LlavaConfig:
    sparse = SparseConfig(
        d_model=32, nhead=2, dim_feedforward=64, num_layers=1,
        use_vision_predictor=False, use_text_predictor=False,
        use_output_text_predictor=False, use_instruct_predictor=False,
    )
    return LlavaConfig.tiny(sparse=dataclasses.replace(sparse, **sparse_overrides))


class Pair:
    """A JAX and a port ``Generator`` on the same weights and settings."""

    def __init__(self, cfg, seed, **gen):
        self.cfg = cfg
        self.jp = _jinit(jax.random.key(seed), cfg)
        self.tp = params_from_numpy(jax.tree.map(np.asarray, self.jp), "cpu", torch.float32)
        self.jgen = JGen(self.jp, cfg, JGenCfg(**gen))
        self.tgen = TGen(self.tp, port_config(cfg), TGenCfg(**gen))


def _batch(cfg, rng, lens, with_image):
    ids_list = []
    for n in lens:
        ids = rng.integers(3, cfg.text.vocab_size, size=(n,)).astype(np.int64)
        if with_image:
            ids[2] = -200
        ids_list.append(ids)
    imgs = None
    if with_image:
        imgs = rng.normal(
            size=(len(lens), cfg.vision.image_size, cfg.vision.image_size, 3)
        ).astype(np.float32)
    return ids_list, imgs


LOOKUP_CONTEXTS = [
    [1, 7, 8, 9, 10, 11, 5, 7, 8],
    [2, 4, 2, 6, 2],
    [1, 2, 3],
    [9, 9, 9, 9, 9],
    [5, 6, 7, 5, 6, 8, 5, 6],  # two earlier matches of (5, 6): the latest wins
]


def test_prompt_lookup_draft_unit():
    # trailing bigram (7, 8) occurred earlier, followed by 9, 10, 11
    assert prompt_lookup_draft([1, 7, 8, 9, 10, 11, 5, 7, 8], 3) == [9, 10, 11]
    # latest match wins: second occurrence of (2,) followed by 6
    assert prompt_lookup_draft([2, 4, 2, 6, 2], 1, max_ngram=1) == [6]
    assert prompt_lookup_draft([1, 2, 3], 2) == []  # no repeat -> no draft
    for ctx in LOOKUP_CONTEXTS:
        for k, g in ((1, 1), (3, 3), (4, 2)):
            assert prompt_lookup_draft(ctx, k, max_ngram=g) == jdraft(ctx, k, max_ngram=g)


CASES = [
    # (sparse overrides, with_image, draft_k, bound, cache_dtype)
    (dict(), False, 4, True, "bfloat16"),
    (dict(use_output_text_predictor=True, use_text_predictor=True,
          output_text_keep_rate=0.5), False, 3, True, "int8"),
    (dict(use_vision_predictor=True, vision_keep_rate=0.25,
          use_output_text_predictor=True, use_text_predictor=True), True, 5,
     True, "float8_e4m3fn"),
    (dict(use_output_text_predictor=True, use_text_predictor=True), False, 2,
     False, "bfloat16"),
]


def _case_pair(case, seed_base):
    overrides, with_image, k, bound, cache_dtype = CASES[case]
    cfg = _cfg(**overrides)
    eos = cfg.text.vocab_size + 7  # unreachable: run the full budget
    pair = Pair(cfg, seed_base + case, max_new_tokens=14, decode_chunk=4, eos_token_id=eos,
                bound_kv_budget=bound, pad_multiple=1, cache_dtype=cache_dtype)
    return pair, with_image, k


@pytest.mark.parametrize("case", range(len(CASES)))
def test_speculative_matches_greedy_any_draft(case):
    """Adversarial-random and prompt-lookup drafts: the port's tokens equal
    its plain greedy tokens and the JAX speculative tokens."""
    pair, with_image, k = _case_pair(case, 40)
    rng = np.random.default_rng(50 + case)
    ids_list, imgs = _batch(pair.cfg, rng, (7, 11), with_image)
    ref = pair.tgen.generate(ids_list, imgs)

    def random_draft(ctx, n):
        # adversarial: unrelated tokens, occasionally empty
        r = np.random.default_rng(len(ctx))
        if r.integers(3) == 0:
            return []
        return [int(t) for t in r.integers(3, pair.cfg.text.vocab_size, size=n)]

    for draft in (random_draft, "prompt_lookup"):
        got = pair.tgen.generate_speculative(ids_list, imgs, draft=draft, draft_k=k)
        want = pair.jgen.generate_speculative(ids_list, imgs, draft=draft, draft_k=k)
        assert got == ref, f"case {case} draft {draft}"
        assert got == want, f"case {case} draft {draft}: port != JAX"


def _eos_pair(seed=9):
    cfg = _cfg()
    probe = Pair(cfg, seed, max_new_tokens=10, decode_chunk=4,
                 eos_token_id=cfg.text.vocab_size + 7, pad_multiple=1)
    ids_list, _ = _batch(cfg, np.random.default_rng(seed), (8, 6), False)
    eos = probe.tgen.generate(ids_list)[0][3]  # fires mid-generation for sample 0
    pair = Pair(cfg, seed, max_new_tokens=10, decode_chunk=4, eos_token_id=int(eos),
                pad_multiple=1)
    return pair, ids_list


def test_speculative_eos_and_stats():
    """EOS mid-round: the accepted prefix cuts at EOS (emitted, nothing past
    it), as on the plain path; stats and the streamed tokens as in JAX."""
    pair, ids_list = _eos_pair()
    ref = pair.tgen.generate(ids_list)
    assert any(len(o) < 10 for o in ref)  # EOS actually fired somewhere
    got_stats, want_stats, got_stream, want_stream = {}, {}, [], []
    out = pair.tgen.generate_speculative(
        ids_list, draft="prompt_lookup", draft_k=3, stats=got_stats,
        on_tokens=lambda i, new: got_stream.append((i, list(new))))
    want = pair.jgen.generate_speculative(
        ids_list, draft="prompt_lookup", draft_k=3, stats=want_stats,
        on_tokens=lambda i, new: want_stream.append((i, [int(t) for t in new])))
    assert out == ref == want
    assert got_stats == want_stats
    assert got_stats["rounds"] >= 1 and got_stats["emitted"] == sum(len(o) for o in ref)
    assert got_stream == want_stream


def test_speculative_oracle_draft_hits_mechanical_ceiling():
    """An oracle draft (the true continuation) is accepted in full: rounds
    == ceil(max_new / (draft_k + 1)), on both sides."""
    cfg = _cfg(use_output_text_predictor=True, use_text_predictor=True)
    eos = cfg.text.vocab_size + 7
    max_new, k = 16, 3
    pair = Pair(cfg, 12, max_new_tokens=max_new, decode_chunk=4, eos_token_id=eos,
                pad_multiple=1)
    ids_list, _ = _batch(cfg, np.random.default_rng(12), (9,), False)
    ref = pair.tgen.generate(ids_list)[0]
    full = [int(t) for t in np.asarray(ids_list[0])] + ref

    def oracle(ctx, n):
        return full[len(ctx): len(ctx) + n]

    stats, jstats = {}, {}
    out = pair.tgen.generate_speculative(ids_list, draft=oracle, draft_k=k, stats=stats)
    assert out[0] == ref
    assert pair.jgen.generate_speculative(ids_list, draft=oracle, draft_k=k,
                                          stats=jstats)[0] == ref
    assert stats["rounds"] == jstats["rounds"] == -(-max_new // (k + 1))
    assert stats["tokens_per_round"] == pytest.approx(max_new / stats["rounds"])


def test_device_prompt_lookup_matches_host_semantics():
    """The device matcher proposes what the host version does (0-padded),
    and exactly what the JAX device matcher does on the same grid."""
    k, cap = 3, 16
    ctx = np.zeros((len(LOOKUP_CONTEXTS), cap), np.int32)
    lens = np.zeros(len(LOOKUP_CONTEXTS), np.int32)
    for i, c in enumerate(LOOKUP_CONTEXTS):
        ctx[i, : len(c)] = c
        lens[i] = len(c)
    for g in (3, 1):
        got = device_prompt_lookup(torch.from_numpy(ctx), torch.from_numpy(lens), k,
                                   max_ngram=g).numpy()
        want = np.asarray(jlookup(jnp.asarray(ctx), jnp.asarray(lens), k, max_ngram=g))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
        for i, c in enumerate(LOOKUP_CONTEXTS):
            host = prompt_lookup_draft(c, k, max_ngram=g)
            assert [int(t) for t in got[i]][: len(host)] == host, (g, i, got[i], host)


@pytest.mark.parametrize("case", [0, 2])
def test_speculative_device_loop_matches_greedy(case, monkeypatch):
    """The device loop (in-graph drafting, chunks of rounds, one host read a
    chunk) is token-exact against greedy and the JAX device loop."""
    monkeypatch.setattr(speculative, "ROUNDS_PER_CHUNK", 3)
    pair, with_image, k = _case_pair(case, 60)
    rng = np.random.default_rng(70 + case)
    ids_list, imgs = _batch(pair.cfg, rng, (7, 11), with_image)
    ref = pair.tgen.generate(ids_list, imgs)
    stats, jstats = {}, {}
    out = pair.tgen.generate_speculative_device(ids_list, imgs, draft_k=k, stats=stats)
    want = pair.jgen.generate_speculative_device(ids_list, imgs, draft_k=k, stats=jstats)
    assert out == ref == want
    assert stats["rounds"] == jstats["rounds"] and stats["emitted"] == jstats["emitted"]
    assert 1 <= stats["rounds"] <= stats["rounds_run"] <= stats["rounds"] + 2 * 3


def test_speculative_device_loop_eos():
    """Reachable EOS: the device loop stops exactly where greedy does."""
    pair, ids_list = _eos_pair()
    ref = pair.tgen.generate(ids_list)
    out = pair.tgen.generate_speculative_device(ids_list, draft_k=3)
    assert out == ref == pair.jgen.generate_speculative_device(ids_list, draft_k=3)


def test_speculative_rejects_sampling_and_ring():
    cfg = port_config(_cfg())
    from dynamic_llava_tpu_torch.weights import init_llava_params

    params = init_llava_params(cfg, torch.Generator().manual_seed(1), "cpu", torch.float32)
    gen = TGen(params, cfg, TGenCfg(temperature=0.7))
    for call in (gen.generate_speculative, gen.generate_speculative_device):
        with pytest.raises(ValueError, match="greedy"):
            call([np.array([3, 4, 5])])
    gen2 = TGen(params, cfg, TGenCfg(kv_overflow="ring", kv_window=8))
    for call in (gen2.generate_speculative, gen2.generate_speculative_device):
        with pytest.raises(ValueError, match="drop"):
            call([np.array([3, 4, 5])])
    # the step itself refuses a ring-mode state
    plan = plan_batch([np.array([3, 4, 5])], 0, pad_multiple=1)
    with torch.inference_mode():
        state, _ = gen2.prefill_from_plan(plan, None, 8)
        with pytest.raises(ValueError, match="drop mode"):
            tdyn.decode_speculative_step(params, cfg, torch.zeros((1, 2), dtype=torch.long),
                                         state, 2)


def _prefill_both(pair, ids_list, max_new):
    """The two packages' prefilled states of the same plan, sized as the
    speculative loops size them."""
    plan = plan_batch(ids_list, 0, pad_multiple=1)
    jstate, _ = pair.jgen.prefill_from_plan(plan, None, max_new)
    tstate, _ = pair.tgen.prefill_from_plan(plan, None, max_new)
    return jstate, tstate


def test_one_round_state_matches_jax():
    """One ``decode_speculative_step`` with a partly accepted draft (the
    greedy chain's first two tokens, then a wrong one), sparse with a small
    post-tier budget, sample 1 frozen in a second round: tier lengths,
    ``next_pos``, n_acc and next_tok equal JAX's, ``last_logits`` within
    ``LOGITS_ATOL``."""
    cfg = _cfg(use_output_text_predictor=True, use_text_predictor=True,
               output_text_keep_rate=0.5)
    pair = Pair(cfg, 21, max_new_tokens=8, decode_chunk=4,
                eos_token_id=cfg.text.vocab_size + 7, pad_multiple=1)
    ids_list, _ = _batch(cfg, np.random.default_rng(21), (6, 9), False)
    greedy = pair.tgen.generate(ids_list)
    m = 5
    toks = np.full((2, m), 3, np.int32)
    for i in range(2):
        toks[i, :3] = greedy[i][:3]  # t_next and two accepted drafts
        toks[i, 3] = (greedy[i][3] + 1) % cfg.text.vocab_size  # rejected
    jstate, tstate = _prefill_both(pair, ids_list, 8 + m)
    tcfg = port_config(cfg)
    with torch.inference_mode():
        for r, active in enumerate((None, np.array([True, False]))):
            jstate, jn, jnext = jdyn.decode_speculative_step(
                pair.jp, cfg, jnp.asarray(toks), jstate, cfg.text.vocab_size + 7,
                active=None if active is None else jnp.asarray(active))
            tstate, tn, tnext = tdyn.decode_speculative_step(
                pair.tp, tcfg, torch.from_numpy(toks).long(), tstate, cfg.text.vocab_size + 7,
                active=None if active is None else torch.from_numpy(active))
            np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
            if r == 0:  # t_next and two drafts accepted, the greedy chain's 4th token next
                assert tn.tolist() == [3, 3]
                assert tnext.tolist() == [greedy[0][3], greedy[1][3]]
                np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
            else:
                assert tn.tolist()[1] == 0 and tn.tolist()[0] >= 1
            for jt, tt in ((jstate.cache.pre, tstate.cache.pre),
                           (jstate.cache.post, tstate.cache.post)):
                np.testing.assert_array_equal(tt.length.numpy(), np.asarray(jt.length))
            np.testing.assert_array_equal(tstate.next_pos.numpy(), np.asarray(jstate.next_pos))
            np.testing.assert_allclose(tstate.last_logits.numpy(),
                                       np.asarray(jstate.last_logits), atol=LOGITS_ATOL, rtol=0)
            assert tn.dtype == torch.int32 and tstate.cache.post.length.dtype == torch.int32


@pytest.mark.parametrize("draft", [(), (3, 1)], ids=["host drafts", "device lookup"])
def test_spec_round_makes_no_host_read(draft):
    """A round on the runner (drafting, verify, emit, report) reads nothing
    on the host, sparse with an int8 KV cache, in both draft modes, and
    leaves the buffers of the functional ``decode_speculative_step``."""
    cfg = port_config(_cfg(use_output_text_predictor=True, use_text_predictor=True,
                           output_text_keep_rate=0.5))
    from dynamic_llava_tpu_torch.weights import init_llava_params

    params = init_llava_params(cfg, torch.Generator().manual_seed(3), "cpu", torch.float32)
    gen = TGen(params, cfg, TGenCfg(max_new_tokens=10, eos_token_id=-1, pad_multiple=1,
                                    cache_dtype="int8"))
    rng = np.random.default_rng(3)
    ids = [rng.integers(3, 500, 7), rng.integers(3, 500, 10)]
    plan = plan_batch(ids, 0, pad_multiple=1)
    m = 4
    with torch.inference_mode():
        runner = gen.spec_runner(plan, None, 10, m, draft=draft)
        state, _ = gen.prefill_into(plan, None, runner.fresh_cache())
        runner.load(state, 0)
        runner.begin(plan, 10)
        runner.drafts.copy_(torch.from_numpy(rng.integers(3, 500, (2, m - 1)).astype(np.int32)))
        with no_host_reads():
            runner.step()
            runner.step()
        assert gen.decode_runner is runner and runner.key.m == m
        assert (runner.n_out > 0).all() and int(runner.rounds[0]) == 2
