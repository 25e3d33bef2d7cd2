"""Zero-padding a head_dim to the attention kernels' 64 or 128
(``ops.flash_attention.kernel_head_dim`` / ``pad_head_dim``) computes the
same function.

On a CUDA tensor the K1, K3, K4 and K2 wrappers pad a smaller head_dim (the
quality gates' toy configurations: 16 and 32) with zero columns, pass the
true head_dim's scale, and slice the result back. Here the plain versions
of those kernels run on padded inputs the same way and are held against
themselves on the unpadded ones, within 1e-6 (fp32: the zero columns add
exact zeros, only the order of the sums may change). The card runs the
padded cases of ``kernel_cases`` (``tests/test_torch_card_kernels.py``).
"""

import numpy as np
import pytest
import torch

from dynamic_llava_tpu_torch.ops.attention import decode_attend_appended
from dynamic_llava_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_plain, flash_attention_plain, kernel_head_dim, pad_head_dim)
from dynamic_llava_tpu_torch.ops.flash_policy import flash_policy_attention_plain

TOL = dict(atol=1e-6, rtol=1e-6)


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


def test_kernel_head_dim_rounds_up_to_the_kernels_widths():
    assert [kernel_head_dim(d) for d in (8, 16, 32, 64, 96, 128, 256)] == \
        [64, 64, 64, 64, 128, 128, 256]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.float8_e4m3fn])
def test_pad_head_dim_appends_zero_columns(dtype):
    t = _randn(np.random.default_rng(0), 2, 3, 16).to(dtype)
    p = pad_head_dim(t, 64)
    assert p.dtype == dtype and p.shape == (2, 3, 64) and p.is_contiguous()
    assert torch.equal(p[..., :16].float(), t.float()) and not p[..., 16:].float().any()
    assert pad_head_dim(t, 16) is t


@pytest.mark.parametrize("d", [16, 32, 96])
def test_padded_flash_forward_and_backward_equal_the_unpadded(d):
    rng = np.random.default_rng(d)
    b, s, h, hkv = 3, 37, 4, 2
    q, k, v, g = (_randn(rng, b, s, n, d) for n in (h, hkv, hkv, h))
    kv_length = torch.tensor([37, 20, 0], dtype=torch.int32)
    kd, scale = kernel_head_dim(d), d**-0.5
    args = dict(kv_length=kv_length, causal=True)
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **args)
    qp, kp, vp, gp = (pad_head_dim(t, kd) for t in (q, k, v, g))
    out_p, lse_p = flash_attention_plain(qp, kp, vp, return_lse=True, scale=scale, **args)
    torch.testing.assert_close(out_p[..., :d], out, **TOL)
    assert not out_p[..., d:].any()
    torch.testing.assert_close(lse_p, lse, **TOL)
    grads = flash_attention_bwd_plain(q, k, v, out, lse, g, **args)
    grads_p = flash_attention_bwd_plain(qp, kp, vp, out_p, lse_p, gp, scale=scale, **args)
    for got, want in zip(grads_p, grads):
        torch.testing.assert_close(got[..., :d], want, **TOL)
        assert not got[..., d:].any()


@pytest.mark.parametrize("d", [16, 32])
def test_padded_policy_attention_equals_the_unpadded(d):
    rng = np.random.default_rng(d)
    b, s, h, hkv = 2, 29, 4, 4
    q, k, v = (_randn(rng, b, s, n, d) for n in (h, hkv, hkv))
    policy = torch.from_numpy(rng.uniform(size=(b, s)).astype(np.float32))
    policy[:, ::3] = 0.0
    want = flash_policy_attention_plain(q, k, v, policy)
    kd = kernel_head_dim(d)
    got = flash_policy_attention_plain(*(pad_head_dim(t, kd) for t in (q, k, v)), policy,
                                       scale=d**-0.5)
    torch.testing.assert_close(got[..., :d], want, **TOL)
    assert not got[..., d:].any()


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_padded_decode_attention_equals_the_unpadded(storage):
    rng = np.random.default_rng(3)
    b, max_len, h, hkv, d = 4, 40, 4, 2, 16
    q = _randn(rng, b, 1, h, d)
    kc, vc = (_randn(rng, b, max_len, hkv, d) for _ in range(2))
    kn, vn = (_randn(rng, b, 1, hkv, d) for _ in range(2))
    length = torch.tensor([0, 1, 20, 39], dtype=torch.int32)
    kw = {}
    if storage == "int8":
        kc, vc = ((t * 40).round().clamp(-127, 127).to(torch.int8) for t in (kc, vc))
        kw = dict(k_scale=torch.full((b, max_len, hkv), 0.025, dtype=torch.bfloat16),
                  v_scale=torch.full((b, max_len, hkv), 0.03, dtype=torch.bfloat16))
    want = decode_attend_appended(q, kc, vc, kn, vn, length, **kw)
    kd = kernel_head_dim(d)
    got = decode_attend_appended(*(pad_head_dim(t, kd) for t in (q, kc, vc, kn, vn)), length,
                                 scale=d**-0.5, **kw)
    torch.testing.assert_close(got[..., :d], want, **TOL)
    assert not got[..., d:].any()
