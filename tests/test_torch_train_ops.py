"""The training path's ops of the port against the JAX package, on the CPU:
Gumbel sampling on shared noise, the plain policy attention paths, and the
modules of kernels K3 (flash backward) and K4 (policy attention), whose
plain versions are held against the Pallas kernels in interpret mode (as
tests/test_flash_attention.py and tests/test_flash_policy.py run them) and
whose autograd Functions (plain inside, on CPU tensors) are held against
``jax.grad``. The CUDA kernels themselves are compared with these plain
versions on the card by ``chip_smoke.py``.

fp32 throughout. Tolerances: forward and gradients atol 1e-5 / rtol 1e-4
unless a test says otherwise (sums over up to 70 keys in another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dynamic_llava_tpu.ops import attention as jattn
from dynamic_llava_tpu.ops import flash_attention as jflash
from dynamic_llava_tpu.ops import flash_policy as jpolicy
from dynamic_llava_tpu.ops import gumbel as jgumbel
from dynamic_llava_tpu_torch.ops import attention as tattn
from dynamic_llava_tpu_torch.ops import flash_attention as tflash
from dynamic_llava_tpu_torch.ops import flash_policy as tpolicy
from dynamic_llava_tpu_torch.ops import gumbel as tgumbel

ATOL, RTOL = 1e-5, 1e-4


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


def jax_uniform(key, shape):
    """The draw ``gumbel_softmax`` of the JAX package makes from ``key``."""
    return np.asarray(jax.random.uniform(
        key, shape, jnp.float32, minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))


# -- gumbel --------------------------------------------------------------------


@pytest.mark.parametrize("tau", [1.0, 0.3])
@pytest.mark.parametrize("hard", [True, False])
def test_gumbel_softmax_on_shared_noise(tau, hard):
    logits = _np((3, 11, 2), 0)
    key = jax.random.key(7)
    w = _np((3, 11, 2), 1)  # a fixed cotangent

    want, vjp = jax.vjp(lambda x: jgumbel.gumbel_softmax(key, x, tau, hard=hard),
                        jnp.asarray(logits))
    x = _t(logits, grad=True)
    got = tgumbel.gumbel_softmax(_t(jax_uniform(key, logits.shape)), x, tau, hard=hard)
    np.testing.assert_array_equal(got.detach().numpy() > 0.5, np.asarray(want) > 0.5)
    _close(got, want, atol=1e-6)
    got.backward(_t(w))
    _close(x.grad, vjp(jnp.asarray(w))[0], atol=1e-6)


def test_gumbel_keep_mask_and_ste_argmax():
    logits = _np((2, 9, 2), 2)
    key = jax.random.key(3)
    want, vjp = jax.vjp(lambda x: jgumbel.gumbel_keep_mask(key, x, 0.7), jnp.asarray(logits))
    x = _t(logits, grad=True)
    got = tgumbel.gumbel_keep_mask(_t(jax_uniform(key, logits.shape)), x, 0.7)
    assert set(np.unique(got.detach().numpy())) <= {0.0, 1.0}
    _close(got, want, atol=1e-6)
    got.sum().backward()
    _close(x.grad, vjp(jnp.ones_like(want))[0], atol=1e-6)

    want, vjp = jax.vjp(jgumbel.ste_argmax_keep, jnp.asarray(logits))
    x = _t(logits, grad=True)
    got = tgumbel.ste_argmax_keep(x)
    _close(got, want, atol=1e-6)
    got.sum().backward()
    _close(x.grad, vjp(jnp.ones_like(want))[0], atol=1e-6)


def test_gumbel_generator_noise_is_reproducible_and_in_range():
    u1 = tgumbel.uniform_noise(torch.Generator().manual_seed(5), (4, 6, 2), "cpu")
    u2 = tgumbel.uniform_noise(torch.Generator().manual_seed(5), (4, 6, 2), "cpu")
    assert torch.equal(u1, u2) and u1.dtype == torch.float32
    assert float(u1.min()) > 0.0 and float(u1.max()) < 1.0
    with pytest.raises(ValueError, match="uniform noise has shape"):
        tgumbel.gumbel_softmax(torch.ones(3, 2), torch.zeros(4, 2), 1.0)


# -- plain policy attention ------------------------------------------------------


def _qkvp(b, s, h, hkv, d, seed, soft=True):
    rng = np.random.default_rng(seed)
    q, k, v = _np((b, s, h, d), seed), _np((b, s, hkv, d), seed + 1), _np((b, s, hkv, d), seed + 2)
    pol = (rng.uniform(0, 1, (b, s)) if soft else rng.integers(0, 2, (b, s))).astype(np.float32)
    return q, k, v, pol


def _grads_close(t_out, t_inputs, j_fn, j_inputs, cot, atol=ATOL, rtol=RTOL):
    """Forward and the gradients of every input under the cotangent ``cot``."""
    want, vjp = jax.vjp(j_fn, *map(jnp.asarray, j_inputs))
    _close(t_out, want, atol, rtol)
    t_grads = torch.autograd.grad(t_out, t_inputs, _t(cot))
    for tg, jg in zip(t_grads, vjp(jnp.asarray(cot))):
        _close(tg, jg, atol, rtol)


@pytest.mark.parametrize("h,hkv", [(2, 2), (4, 2)])
@pytest.mark.parametrize("lens", [None, [37, 20]])
def test_attend_with_policy_matches_jax(h, hkv, lens):
    b, s, d = 2, 37, 16
    q, k, v, pol = _qkvp(b, s, h, hkv, d, 10)
    kvl = None if lens is None else np.asarray(lens, np.int32)
    jmask = jattn.make_attention_mask(
        s, s, causal=True, batch=b, kv_length=None if kvl is None else jnp.asarray(kvl))
    tmask = tattn.make_attention_mask(
        s, s, causal=True, batch=b, kv_length=None if kvl is None else _t(kvl))
    ins = [_t(a, grad=True) for a in (q, k, v, pol)]
    out = tattn.attend_with_policy(*ins, mask=tmask)
    _grads_close(out, ins, lambda *a: jattn.attend_with_policy(*a, mask=jmask),
                 (q, k, v, pol), _np(q.shape, 14))


@pytest.mark.parametrize("policy", [False, True])
@pytest.mark.parametrize("lens", [None, [70, 33]])
def test_blockwise_attend_matches_jax(policy, lens):
    b, s, h, hkv, d = 2, 70, 4, 2, 16  # 70 is no multiple of the block
    q, k, v, pol = _qkvp(b, s, h, hkv, d, 20)
    kvl = None if lens is None else np.asarray(lens, np.int32)
    arrays = (q, k, v, pol) if policy else (q, k, v)
    ins = [_t(a, grad=True) for a in arrays]

    def jfn(*a):
        return jattn.blockwise_attend(
            a[0], a[1], a[2], policy=a[3] if policy else None, block_q=32,
            kv_length=None if kvl is None else jnp.asarray(kvl))

    out = tattn.blockwise_attend(
        ins[0], ins[1], ins[2], policy=ins[3] if policy else None, block_q=32,
        kv_length=None if kvl is None else _t(kvl))
    _grads_close(out, ins, jfn, arrays, _np(q.shape, 24))
    # and it equals the dense plain path
    if policy and lens is None:
        _close(out, tpolicy.flash_policy_attention_plain(*map(_t, (q, k, v, pol))))


# -- K3: flash backward ----------------------------------------------------------

K3_CASES = [
    # b, s, h, hkv, d, causal, kv_length
    (2, 70, 4, 2, 16, True, [50, 70]),  # the JAX package's own case
    (2, 40, 2, 2, 32, True, None),
    (2, 33, 4, 1, 16, False, [33, 9]),
    (1, 24, 2, 2, 16, False, None),
    (2, 20, 2, 2, 16, True, [0, 20]),  # a sample with no valid column
    # the edges of the card kernels' 64-row tiles: two rows past two tiles
    # with 4 query heads a KV head, a kv_length in mid-tile, a tile and a row
    (1, 130, 8, 2, 64, True, None),
    (2, 130, 4, 1, 64, True, [130, 77]),
    (2, 65, 2, 2, 64, True, [64, 0]),
]


@pytest.mark.parametrize("b,s,h,hkv,d,causal,lens", K3_CASES)
def test_k3_plain_matches_pallas_interpret(b, s, h, hkv, d, causal, lens):
    q, k, v, g = (_np((b, s, h, d), 30), _np((b, s, hkv, d), 31), _np((b, s, hkv, d), 32),
                  _np((b, s, h, d), 33))
    kvl = None if lens is None else np.asarray(lens, np.int32)
    jkvl = None if kvl is None else jnp.asarray(kvl)
    tkvl = None if kvl is None else _t(kvl)
    jout, jlse = jflash.flash_attention(
        *map(jnp.asarray, (q, k, v)), kv_length=jkvl, causal=causal, block_q=32,
        block_k=32, interpret=True, save_residuals=True)
    want = jflash.flash_attention_bwd(
        *map(jnp.asarray, (q, k, v)), jout, jlse, jnp.asarray(g), kv_length=jkvl,
        causal=causal, block_q=32, block_k=32, interpret=True)
    tout, tlse = tflash.flash_attention_plain(
        *map(_t, (q, k, v)), kv_length=tkvl, causal=causal, return_lse=True)
    got = tflash.flash_attention_bwd_plain(
        *map(_t, (q, k, v)), tout, tlse, _t(g), kv_length=tkvl, causal=causal)
    # the dispatcher takes the plain version for CPU tensors
    again = tflash.flash_attention_bwd(
        *map(_t, (q, k, v)), tout, tlse, _t(g), kv_length=tkvl, causal=causal)
    for a, a2, r in zip(got, again, want):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, a2)
        _close(a, r, atol=2e-5, rtol=2e-4)
    # dk and dv are summed over each GQA group: k's shape, k's type
    assert got[0].shape == (b, s, h, d)
    assert got[1].shape == got[2].shape == (b, s, hkv, d)
    assert all(a.dtype == torch.float32 for a in got)


@pytest.mark.parametrize("h,hkv", [(2, 2), (4, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_k3_plain_matches_grad_of_attend(h, hkv, causal):
    b, s, d = 2, 29, 16
    q, k, v, g = (_np((b, s, h, d), 40), _np((b, s, hkv, d), 41), _np((b, s, hkv, d), 42),
                  _np((b, s, h, d), 43))
    kvl = np.asarray([29, 18], np.int32)
    g[1, 18:] = 0.0  # rows past the valid length are padding in both
    jmask = jattn.make_attention_mask(s, s, causal=causal, batch=b, kv_length=jnp.asarray(kvl))
    _, vjp = jax.vjp(lambda *a: jattn.attend(*a, mask=jmask), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tout, tlse = tflash.flash_attention_plain(
        *map(_t, (q, k, v)), kv_length=_t(kvl), causal=causal, return_lse=True)
    got = tflash.flash_attention_bwd_plain(
        *map(_t, (q, k, v)), tout, tlse, _t(g), kv_length=_t(kvl), causal=causal)
    for a, r in zip(got, want):
        _close(a, r, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("lens", [None, [33, 12]])
def test_k1_function_grads_match_jax_vjp(lens):
    """The autograd Function (K1 forward, K3 backward; plain inside on the
    CPU) against ``jax.grad`` of ``flash_attention_vjp`` (Pallas in
    interpret mode on the CPU)."""
    b, s, h, hkv, d = 2, 33, 4, 2, 16
    q, k, v, g = (_np((b, s, h, d), 50), _np((b, s, hkv, d), 51), _np((b, s, hkv, d), 52),
                  _np((b, s, h, d), 53))
    kvl = None if lens is None else np.asarray(lens, np.int32)
    if kvl is not None:
        g[1, 12:] = 0.0
    ins = [_t(a, grad=True) for a in (q, k, v)]
    out = tflash.flash_attention_vjp(*ins, kv_length=None if kvl is None else _t(kvl))
    assert out.grad_fn is not None and "FlashAttentionFn" in type(out.grad_fn).__name__
    _grads_close(
        out, ins,
        lambda *a: jflash.flash_attention_vjp(
            *a, kv_length=None if kvl is None else jnp.asarray(kvl)),
        (q, k, v), g, atol=2e-5, rtol=2e-4)
    # nothing to differentiate: the plain forward, no graph
    with torch.no_grad():
        assert tflash.flash_attention_vjp(*ins).grad_fn is None


def test_self_attend_routes_and_padding_is_not_masked():
    b, s, h, d = 2, 21, 2, 16
    q, k, v, pol = _qkvp(b, s, h, h, d, 60)
    ins = [_t(a, grad=True) for a in (q, k, v, pol)]
    jmask = jattn.make_attention_mask(s, s, causal=True, batch=b)
    out = tattn.self_attend(*ins[:3])
    _close(out, jattn.attend(*map(jnp.asarray, (q, k, v)), mask=jmask))
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    out = tattn.self_attend(*ins[:3], policy=ins[3])
    _close(out, jattn.attend_with_policy(*map(jnp.asarray, (q, k, v, pol)), mask=jmask))
    assert "FlashPolicyFn" in type(out.grad_fn).__name__
    # with a valid_len the policy path is the plain oracle under the combined mask
    kvl = np.asarray([21, 9], np.int32)
    out = tattn.self_attend(*ins[:3], policy=ins[3], valid_len=_t(kvl))
    jm = jattn.make_attention_mask(s, s, causal=True, batch=b, kv_length=jnp.asarray(kvl))
    _close(out, jattn.attend_with_policy(*map(jnp.asarray, (q, k, v, pol)), mask=jm))


# -- K4: policy attention ----------------------------------------------------------


@pytest.mark.parametrize("h,hkv,s", [(2, 2, 48), (4, 2, 37)])
@pytest.mark.parametrize("soft", [False, True])
def test_k4_plain_matches_pallas_interpret(h, hkv, s, soft):
    q, k, v, pol = _qkvp(2, s, h, hkv, 16, 70, soft=soft)
    want = jpolicy.flash_policy_attention(
        *map(jnp.asarray, (q, k, v, pol)), block_q=16, block_k=16, interpret=True)
    got = tpolicy.flash_policy_attention_plain(*map(_t, (q, k, v, pol)))
    _close(got, want, atol=3e-5, rtol=3e-4)  # the JAX test's own tolerance
    jmask = jattn.make_attention_mask(s, s, causal=True, batch=2)
    _close(got, jattn.attend_with_policy(*map(jnp.asarray, (q, k, v, pol)), mask=jmask))
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(got, tpolicy.flash_policy_attention(*map(_t, (q, k, v, pol))))


@pytest.mark.parametrize("h,hkv", [(2, 2), (4, 2)])
def test_k4_function_grads_match_jax_vjp(h, hkv):
    """The autograd Function (K4 forward, blockwise recompute backward)
    against ``flash_policy_attention_vjp`` (Pallas forward in interpret
    mode; its backward is the JAX blockwise recompute)."""
    b, s, d = 2, 32, 16
    q, k, v, pol = _qkvp(b, s, h, hkv, d, 80)
    ins = [_t(a, grad=True) for a in (q, k, v, pol)]
    out = tpolicy.flash_policy_attention_vjp(*ins)
    assert "FlashPolicyFn" in type(out.grad_fn).__name__
    _grads_close(out, ins, jpolicy.flash_policy_attention_vjp, (q, k, v, pol),
                 _np(q.shape, 84), atol=3e-5, rtol=3e-4)
    # a policy that needs no gradient gets none
    ins = [_t(a, grad=i < 3) for i, a in enumerate((q, k, v, pol))]
    out = tpolicy.flash_policy_attention_vjp(*ins)
    grads = torch.autograd.grad(out.sum(), ins[:3])
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_kernel_wrappers_count_no_launch_on_cpu():
    q, k, v, pol = map(_t, _qkvp(1, 8, 2, 2, 16, 90))
    before = (tflash.flash_attention_bwd_dq.launches, tflash.flash_attention_bwd_dkv.launches,
              tpolicy.flash_policy_attention.launches)
    out, lse = tflash.flash_attention(q, k, v, return_lse=True)
    tflash.flash_attention_bwd(q, k, v, out, lse, torch.ones_like(q))
    tpolicy.flash_policy_attention(q, k, v, pol)
    assert before == (tflash.flash_attention_bwd_dq.launches,
                      tflash.flash_attention_bwd_dkv.launches,
                      tpolicy.flash_policy_attention.launches)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_attention_bwd_dq(q, k, v, q, lse, lse)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_attention_bwd_dkv(q, k, v, q, lse, lse)
