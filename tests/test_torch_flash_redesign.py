"""What the tensor-core forms of kernels K1 and K3 must keep, on the CPU: the
contract of the backward's outputs, the plain delta against the JAX
wrapper's, the arithmetic the bf16 tensor-core path adds (probabilities and
dS rounded to bf16 before the second products) inside the tolerance the card
check holds the kernels to, and the wrappers' refusals and CPU routes. The
CUDA kernels themselves are compared with the plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dynamic_llava_tpu_torch.ops import flash_attention as tflash
from dynamic_llava_tpu_torch.ops.attention import repeat_kv_heads

# the card check's tolerance for bf16 tensors (chip_smoke.py BF16_TOL): one
# bf16 rounding of an output of size O(1) is 2^-9 ~ 2e-3, and the rounded
# probabilities and dS add errors of the same relative size to each of up
# to S terms, which mostly cancel
BF16_TOL = 2e-2


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_valued(shape, seed):
    """fp32 tensors whose values are exactly representable in bf16."""
    return _t(_np(shape, seed)).bfloat16().float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4)])
def test_k3_plain_outputs_have_kv_shape_and_dtype(dtype, h, hkv):
    """dk and dv come back as [B, Sk, Hkv, d] in k's dtype, dq as q's: the
    contract the kernel's in-block loop over a GQA group keeps."""
    b, s, d = 2, 70, 64
    q, k, v, g = (_t(_np((b, s, h, d), 1)).to(dtype), _t(_np((b, s, hkv, d), 2)).to(dtype),
                  _t(_np((b, s, hkv, d), 3)).to(dtype), _t(_np((b, s, h, d), 4)).to(dtype))
    kvl = torch.tensor([70, 33], dtype=torch.int32)
    out, lse = tflash.flash_attention(q, k, v, kv_length=kvl, return_lse=True)
    dq, dk, dv = tflash.flash_attention_bwd(q, k, v, out, lse, g, kv_length=kvl)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    # columns at or past kv_length receive no gradient
    assert float(dk[1, 33:].abs().max()) == 0.0 and float(dv[1, 33:].abs().max()) == 0.0
    # the group sum is the sum of the per-query-head gradients
    if h != hkv and dtype == torch.float32:
        per_head = tflash.flash_attention_bwd(
            q, repeat_kv_heads(k, h // hkv), repeat_kv_heads(v, h // hkv), out, lse, g,
            kv_length=kvl)
        want = per_head[1].reshape(b, s, hkv, h // hkv, d).sum(3)
        torch.testing.assert_close(dk, want, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_delta_plain_matches_jax_wrapper(dtype):
    """``_delta`` against the expression of the JAX wrapper
    (``flash_attention_bwd``: the fp32 sum of ``g * out`` over d, as
    [B, H, Sq]); the same products, sums of 64 terms in another order."""
    b, s, h, d = 2, 37, 4, 64
    out = jnp.asarray(_np((b, s, h, d), 10)).astype(dtype)
    g = jnp.asarray(_np((b, s, h, d), 11)).astype(dtype)
    want = jnp.sum(g.astype(jnp.float32) * out.astype(jnp.float32), axis=-1).transpose(0, 2, 1)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tout = _t(np.asarray(out.astype(jnp.float32))).to(tdtype)
    tg = _t(np.asarray(g.astype(jnp.float32))).to(tdtype)
    got = tflash._delta(tout, tg)
    assert got.shape == (b, h, s) and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _tensor_core_arithmetic(q, k, v, g, kvl, causal):
    """The forward and backward as the bf16 kernels compute them: fp32
    scores, softmax and accumulators, but the unnormalised probabilities of
    the forward, and P and dS of the backward, rounded to bf16 before the
    products that consume them (the tensor cores take bf16 operands)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = h // hkv
    scale = d**-0.5
    kf, vf = repeat_kv_heads(k, n_rep), repeat_kv_heads(v, n_rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kf) * scale
    cols = torch.arange(sk)
    mask = (cols[None, :] < kvl[:, None])[:, None, None, :].expand(b, 1, sq, sk)
    if causal:
        mask = mask & (cols[None, :] <= torch.arange(sq)[:, None])[None, None]
    s = torch.where(mask, s, -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)  # the sum is of the fp32 values
    out = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), vf) / l.transpose(1, 2)
    out = out.bfloat16().float()  # the kernel's output type
    lse = (m + torch.log(l))[..., 0]
    pn = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g, vf)
    ds = pn * (dp - tflash._delta(out, g)[..., None]) * scale
    pb, dsb = pn.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, g)
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, q)
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, kf)
    group = lambda x: x.reshape(b, sk, hkv, n_rep, d).sum(3)
    return out, dq, group(dk), group(dv)


@pytest.mark.parametrize("causal,lens", [(True, [200, 77]), (False, [150, 200])])
def test_bf16_operands_stay_within_the_card_tolerance(causal, lens):
    """Rounding P and dS to bf16 before the second products, on bf16-valued
    inputs at S=200, d=128, stays within atol = rtol = 2e-2 of the fp32
    plain versions: the tolerance the card check holds the bf16 kernels to,
    so that tolerance has room for the kernels' arithmetic and no more
    than that is being excused."""
    b, s, h, hkv, d = 2, 200, 4, 2, 128
    q, k, v, g = (_bf16_valued((b, s, h, d), 20), _bf16_valued((b, s, hkv, d), 21),
                  _bf16_valued((b, s, hkv, d), 22), _bf16_valued((b, s, h, d), 23))
    kvl = torch.tensor(lens, dtype=torch.int32)
    rout, rlse = tflash.flash_attention_plain(q, k, v, kv_length=kvl, causal=causal,
                                              return_lse=True)
    want = (rout,) + tflash.flash_attention_bwd_plain(q, k, v, rout, rlse, g, kv_length=kvl,
                                                      causal=causal)
    got = _tensor_core_arithmetic(q, k, v, g, kvl, causal)
    worst = 0.0
    for name, a, r in zip(("out", "dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, r, atol=BF16_TOL, rtol=BF16_TOL, msg=name)
        worst = max(worst, float((a - r).abs().max()))
    assert worst > 0.0  # the emulation does round: it is not the plain version again


def test_wrappers_refuse_what_the_kernels_do_not_take():
    b, s, h, d = 1, 16, 2, 64
    q, k, v = _t(_np((b, s, h, d), 30)), _t(_np((b, s, h, d), 31)), _t(_np((b, s, h, d), 32))
    lse = torch.zeros(b, h, s)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.check_qkv("flash_attention", q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.check_qkv("flash_attention", q, k[:, ::2], v[:, ::2])
    with pytest.raises(ValueError, match="head_dim must be 64 or 128"):
        tflash.check_qkv("flash_attention", q[..., :32].contiguous(),
                         k[..., :32].contiguous(), v[..., :32].contiguous())
    with pytest.raises(ValueError, match="multiple"):
        tflash.check_qkv("flash_attention", _t(_np((b, s, 3, d), 33)), k, v)
    with pytest.raises(ValueError, match="contiguous"):  # one dtype for all
        tflash.check_qkv("flash_attention", q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="is on"):
        tflash.check_qkv("flash_attention", q, k.to("meta"), v)
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="unsupported dtype"):
        tflash.check_qkv("flash_attention", q.half(), k.half(), v.half())
    # the backward: causal needs Sq == Sk, g and lse shapes
    k2, v2 = _t(_np((b, 2 * s, h, d), 34)), _t(_np((b, 2 * s, h, d), 35))
    with pytest.raises(ValueError, match="Sq == Sk"):
        tflash._bwd_args(q, k2, v2, q, lse, lse, None, True)
    assert len(tflash._bwd_args(q, k2, v2, q, lse, lse, None, False)) == 7
    with pytest.raises(ValueError, match="q's shape"):
        tflash._bwd_args(q, k, v, k2, lse, lse, None, True)
    with pytest.raises(ValueError, match=r"\[B, H, Sq\]"):
        tflash._bwd_args(q, k, v, q, lse[:, :1].contiguous(), lse, None, True)
    with pytest.raises(ValueError, match="kv_length"):
        tflash._bwd_args(q, k, v, q, lse, lse, torch.zeros(b + 1, dtype=torch.int32), True)
    with pytest.raises(ValueError, match="kv_length"):
        tflash._bwd_args(q, k, v, q, lse, lse, torch.zeros(b, dtype=torch.int64), True)


def test_kernel_halves_are_cuda_only_and_cpu_routes_count_no_launch():
    b, s, h, d = 1, 9, 2, 64
    q, k, v, g = (_t(_np((b, s, h, d), 40 + i)) for i in range(4))
    wrappers = (tflash.flash_attention, tflash.flash_attention_bwd_delta,
                tflash.flash_attention_bwd_dq, tflash.flash_attention_bwd_dkv)
    before = [w.launches for w in wrappers]
    out, lse = tflash.flash_attention(q, k, v, return_lse=True)
    assert torch.equal(out, tflash.flash_attention_plain(q, k, v))
    got = tflash.flash_attention_bwd(q, k, v, out, lse, g)
    want = tflash.flash_attention_bwd_plain(q, k, v, out, lse, g)
    assert all(torch.equal(a, r) for a, r in zip(got, want))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(tflash.flash_attention_vjp(*ins), ins, g)
    assert all(torch.equal(a, r) for a, r in zip(grads, want))
    assert [w.launches for w in wrappers] == before
    delta = tflash._delta(out, g)
    for fn, args in ((tflash.flash_attention_bwd_delta, (out, g)),
                     (tflash.flash_attention_bwd_dq, (q, k, v, g, lse, delta)),
                     (tflash.flash_attention_bwd_dkv, (q, k, v, g, lse, delta))):
        with pytest.raises(ValueError, match="not a CUDA tensor"):
            fn(*args)
