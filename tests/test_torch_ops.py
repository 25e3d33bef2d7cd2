"""PyTorch port ops against the JAX package: norm, rope, attention masks,
the plain attention oracle and the sparsify functions. Inputs come from
numpy seeds and run through both packages in fp32; tolerance atol 1e-5 /
rtol 1e-4 unless a test says otherwise."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dynamic_llava_tpu.config import LlamaConfig, RopeScalingConfig
from dynamic_llava_tpu.ops import attention as jatt
from dynamic_llava_tpu.ops import norm as jnorm
from dynamic_llava_tpu.ops import rope as jrope
from dynamic_llava_tpu.ops import sparsify as jsp
from dynamic_llava_tpu_torch.ops import attention as tatt
from dynamic_llava_tpu_torch.ops import norm as tnorm
from dynamic_llava_tpu_torch.ops import rope as trope
from dynamic_llava_tpu_torch.ops import sparsify as tsp

from test_torch_config import port_config

ATOL, RTOL = 1e-5, 1e-4


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


def test_rms_norm_matches_jax():
    x, w = _np((2, 5, 64), 0), _np((64,), 1)
    _close(tnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


def test_layer_norm_matches_jax():
    x, w, b = _np((2, 5, 48), 2) * 3 + 1, _np((48,), 3), _np((48,), 4)
    _close(
        tnorm.layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-5),
        jnorm.layer_norm(*map(jnp.asarray, (x, w, b)), 1e-5),
    )


def test_norm_cast_order_bf16():
    """The weight multiplies AFTER the cast back to the working dtype."""
    x, w = _np((3, 64), 5), _np((64,), 6)
    got = tnorm.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    want = jnorm.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize(
    "scaling",
    [None, RopeScalingConfig("linear", 2.0)],
    ids=["plain", "linear"],
)
def test_apply_rope_matches_jax(scaling):
    x = _np((2, 40, 3, 32), 7)
    pos = np.random.default_rng(8).permutation(80)[:80].reshape(2, 40).astype(np.int32)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), scaling=scaling)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), scaling=scaling)
    _close(got, want)


# mirrors tests/test_rope_ntk.py: a tiny trained context stretched cheaply
MPE, DIM = 64, 32


@pytest.mark.parametrize("seq_len", [48, 96, 200])
def test_dynamic_ntk_cos_sin_matches_jax(seq_len):
    scaling = RopeScalingConfig(rope_type="dynamic", factor=2.0)
    positions = np.arange(seq_len, dtype=np.int32)[None]
    got = trope.rope_cos_sin(torch.from_numpy(positions), DIM, scaling=scaling,
                             max_position_embeddings=MPE)
    want = jrope.rope_cos_sin(jnp.asarray(positions), DIM, scaling=scaling,
                              max_position_embeddings=MPE)
    for g, w in zip(got, want):
        _close(g, w, atol=2e-5)


def test_dynamic_ntk_rotation_matches_jax():
    s = 3 * MPE
    q = _np((1, s, 2, DIM), 9)
    positions = np.arange(s, dtype=np.int32)[None]
    scaling = RopeScalingConfig(rope_type="dynamic", factor=4.0)
    got = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(positions),
                           scaling=scaling, max_position_embeddings=MPE)
    want = jrope.apply_rope(jnp.asarray(q), jnp.asarray(positions),
                            scaling=scaling, max_position_embeddings=MPE)
    _close(got, want, atol=3e-5)


def test_dynamic_ntk_decode_position_consistency():
    """A decode position [B, 1] derives seq_len = pos + 1: its table equals
    the matching row of the full-prefix table."""
    scaling = RopeScalingConfig(rope_type="dynamic", factor=2.0)
    s = 150
    full_c, full_s = trope.rope_cos_sin(
        torch.arange(s, dtype=torch.int32)[None], DIM, scaling=scaling,
        max_position_embeddings=MPE)
    one_c, one_s = trope.rope_cos_sin(
        torch.tensor([[s - 1]], dtype=torch.int32), DIM, scaling=scaling,
        max_position_embeddings=MPE)
    torch.testing.assert_close(one_c[0, 0], full_c[0, -1], atol=1e-6, rtol=0)
    torch.testing.assert_close(one_s[0, 0], full_s[0, -1], atol=1e-6, rtol=0)


def test_apply_rope_for_config_matches_jax():
    cfg = LlamaConfig.tiny(rope_theta=500000.0)
    x = _np((2, 9, 4, 16), 10)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    _close(trope.apply_rope_for_config(torch.from_numpy(x), torch.from_numpy(pos), port_config(cfg)),
           jrope.apply_rope_for_config(jnp.asarray(x), jnp.asarray(pos), cfg))


@pytest.mark.parametrize("causal,offset,lengths,valid", [
    (True, None, None, False),
    (True, [0, 3], [5, 7], False),
    (False, None, [0, 6], True),
])
def test_make_attention_mask_matches_jax(causal, offset, lengths, valid):
    b, sq, sk = 2, 4, 7
    kw_t, kw_j = {}, {}
    if offset is not None:
        kw_t["q_offset"] = torch.tensor(offset, dtype=torch.int32)
        kw_j["q_offset"] = jnp.asarray(offset, jnp.int32)
    if lengths is not None:
        kw_t["kv_length"] = torch.tensor(lengths, dtype=torch.int32)
        kw_j["kv_length"] = jnp.asarray(lengths, jnp.int32)
    if valid:
        kv = np.random.default_rng(11).integers(0, 2, (b, sk)).astype(bool)
        kw_t["kv_valid"], kw_j["kv_valid"] = torch.from_numpy(kv), jnp.asarray(kv)
    got = tatt.make_attention_mask(sq, sk, causal=causal, batch=b, **kw_t)
    want = jatt.make_attention_mask(sq, sk, causal=causal, batch=b, **kw_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_attend_matches_jax_gqa_masked():
    b, s, h, hkv, d = 2, 11, 4, 2, 16
    q, k, v = _np((b, s, h, d), 12), _np((b, s, hkv, d), 13), _np((b, s, hkv, d), 14)
    lens = np.array([6, 11], np.int32)
    mask_t = tatt.make_attention_mask(s, s, causal=True, batch=b,
                                      kv_length=torch.from_numpy(lens))
    mask_j = jatt.make_attention_mask(s, s, causal=True, batch=b,
                                      kv_length=jnp.asarray(lens))
    _close(tatt.attend(*map(torch.from_numpy, (q, k, v)), mask=mask_t),
           jatt.attend(*map(jnp.asarray, (q, k, v)), mask=mask_j))


def _topk_both(scores, budget, cand):
    got = tsp.topk_keep_mask(torch.from_numpy(scores), budget, torch.from_numpy(cand))
    want = jsp.topk_keep_mask(jnp.asarray(scores), budget, jnp.asarray(cand))
    return got.numpy(), np.asarray(want)


def test_topk_keep_mask_distinct_scores():
    scores = _np((3, 20), 15)
    cand = np.zeros((3, 20), bool)
    cand[:, 4:16] = True
    got, want = _topk_both(scores, 5, cand)
    np.testing.assert_array_equal(got, want)
    assert (got.sum(1) == 5).all() and not (got & ~cand).any()


def test_topk_keep_mask_ties_go_to_lower_index():
    """Equal scores: the lower index wins, as jax.lax.top_k promises."""
    scores = np.zeros((2, 12), np.float32)
    scores[1, [3, 7, 9]] = 1.0  # three-way tie on top, then a tie of zeros
    cand = np.ones((2, 12), bool)
    cand[0, 1] = False
    got, want = _topk_both(scores, 4, cand)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.nonzero(got[0])[0], [0, 2, 3, 4])
    np.testing.assert_array_equal(np.nonzero(got[1])[0], [0, 3, 7, 9])


def test_topk_keep_mask_fewer_candidates_than_budget():
    scores = _np((2, 8), 16)
    cand = np.zeros((2, 8), bool)
    cand[0, [2, 5]] = True
    got, want = _topk_both(scores, 4, cand)
    np.testing.assert_array_equal(got, want)
    assert got[0].sum() == 2 and got[1].sum() == 0


@pytest.mark.parametrize("out_len", [None, 9])
def test_plan_compaction_is_stable(out_len):
    keep = np.random.default_rng(17).integers(0, 2, (3, 14)).astype(bool)
    keep[2] = False  # an empty row keeps the original order too
    got = tsp.plan_compaction(torch.from_numpy(keep), out_len=out_len)
    want = jsp.plan_compaction(jnp.asarray(keep), out_len=out_len)
    np.testing.assert_array_equal(got.gather_idx.numpy(), np.asarray(want.gather_idx))
    np.testing.assert_array_equal(got.new_length.numpy(), np.asarray(want.new_length))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for row, idx, n in zip(keep, got.gather_idx.numpy(), got.new_length.numpy()):
        kept = np.nonzero(row)[0]
        np.testing.assert_array_equal(idx[:n], kept[: len(idx)][:n])  # ascending
        assert list(idx[n:]) == sorted(idx[n:])  # dropped tail in order too


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_gather_tokens_matches_jax(ndim):
    shape = (2, 10) + (3, 4)[: ndim - 2]
    x = _np(shape, 18)
    idx = np.stack([np.random.default_rng(19 + i).permutation(10)[:6] for i in range(2)])
    idx = idx.astype(np.int32)
    _close(tsp.gather_tokens(torch.from_numpy(x), torch.from_numpy(idx)),
           jsp.gather_tokens(jnp.asarray(x), jnp.asarray(idx)), atol=0, rtol=0)
