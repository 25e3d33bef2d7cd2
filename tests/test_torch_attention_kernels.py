"""The plain versions of the port's attention kernels against the JAX
package, and the wrappers' CPU dispatch and argument checks.

K1 (``ops.flash_attention``) is held against the Pallas
``flash_attention`` in interpret mode (as tests/test_flash_attention.py
runs it) and against ``attend`` + ``make_attention_mask``. K2
(``ops.decode_attention``) is held against ``decode_attend_appended`` and
against the Pallas ``flash_decode_attention`` in interpret mode after the
current K/V are written at slot ``length`` of a numpy copy of the cache.
The CUDA kernels themselves are checked against these plain versions on
the card by ``chip_smoke.py``. fp32 throughout; atol 1e-5 / rtol 1e-4.
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dynamic_llava_tpu.ops.attention import attend, decode_attend_appended, make_attention_mask
from dynamic_llava_tpu.ops.decode_attention import flash_decode_attention
from dynamic_llava_tpu.ops.flash_attention import flash_attention as jax_flash
from dynamic_llava_tpu_torch import kernels
from dynamic_llava_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from dynamic_llava_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

ATOL, RTOL = 1e-5, 1e-4


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


K1_CASES = [
    # b, s, h, hkv, d, causal, kv_length
    (2, 40, 2, 2, 64, True, None),
    (2, 33, 4, 2, 64, True, [33, 17]),
    (3, 24, 2, 1, 128, True, [0, 24, 5]),
    (2, 29, 2, 2, 64, False, None),
    (1, 20, 4, 2, 128, False, [13]),
]


@pytest.mark.parametrize("b,s,h,hkv,d,causal,lens", K1_CASES)
def test_k1_plain_matches_pallas_interpret(b, s, h, hkv, d, causal, lens):
    q, k, v = _np((b, s, h, d), 0), _np((b, s, hkv, d), 1), _np((b, s, hkv, d), 2)
    kvl = None if lens is None else np.asarray(lens, np.int32)
    got, got_lse = flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)),
        kv_length=None if kvl is None else torch.from_numpy(kvl),
        causal=causal, return_lse=True)
    want, want_lse = jax_flash(
        *map(jnp.asarray, (q, k, v)),
        kv_length=None if kvl is None else jnp.asarray(kvl),
        causal=causal, interpret=True, save_residuals=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,s,h,hkv,d,causal,lens", K1_CASES)
def test_k1_plain_matches_attend_oracle(b, s, h, hkv, d, causal, lens):
    """Rows that see at least one column equal the oracle; rows that see
    none (kv_length 0) are 0 where the oracle averages v."""
    q, k, v = _np((b, s, h, d), 3), _np((b, s, hkv, d), 4), _np((b, s, hkv, d), 5)
    kvl = None if lens is None else np.asarray(lens, np.int32)
    mask = make_attention_mask(
        s, s, causal=causal, batch=b,
        kv_length=None if kvl is None else jnp.asarray(kvl))
    want = np.asarray(attend(*map(jnp.asarray, (q, k, v)), mask=mask))
    got = flash_attention(
        *map(torch.from_numpy, (q, k, v)),
        kv_length=None if kvl is None else torch.from_numpy(kvl),
        causal=causal).numpy()
    seen = np.asarray(mask)[:, 0].any(-1)  # [B, Sq]
    np.testing.assert_allclose(got[seen], want[seen], atol=ATOL, rtol=RTOL)
    assert (got[~seen] == 0).all()


def test_k1_q_offset_matches_pallas_interpret():
    b, sq, sk, h, d = 2, 16, 40, 2, 64
    q, k, v = _np((b, sq, h, d), 6), _np((b, sk, h, d), 7), _np((b, sk, h, d), 8)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), q_offset=24)
    want = jax_flash(*map(jnp.asarray, (q, k, v)), q_offset_static=24, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


K2_CASES = [
    # hkv, n_rep, d, max_len
    (2, 1, 64, 48),
    (2, 2, 128, 40),
    (1, 4, 64, 33),
]


@pytest.mark.parametrize("hkv,n_rep,d,max_len", K2_CASES)
def test_k2_plain_matches_decode_attend_appended(hkv, n_rep, d, max_len):
    b, h = 3, hkv * n_rep
    q = _np((b, 1, h, d), 10)
    kc, vc = _np((b, max_len, hkv, d), 11), _np((b, max_len, hkv, d), 12)
    kn, vn = _np((b, 1, hkv, d), 13), _np((b, 1, hkv, d), 14)
    length = np.array([0, max_len // 2, max_len - 1], np.int32)
    got = decode_attention(*map(torch.from_numpy, (q, kc, vc, kn, vn, length)))
    want = decode_attend_appended(*map(jnp.asarray, (q, kc, vc, kn, vn, length)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hkv,n_rep,d,max_len", K2_CASES)
def test_k2_plain_matches_pallas_decode_interpret(hkv, n_rep, d, max_len):
    """The Pallas kernel reads the current token from slot ``length``: write
    it into a copy of the cache, then compare."""
    b, h = 3, hkv * n_rep
    q = _np((b, 1, h, d), 15)
    kc, vc = _np((b, max_len, hkv, d), 16), _np((b, max_len, hkv, d), 17)
    kn, vn = _np((b, 1, hkv, d), 18), _np((b, 1, hkv, d), 19)
    length = np.array([0, max_len // 3, max_len - 1], np.int32)
    kw, vw = kc.copy(), vc.copy()
    for i, n in enumerate(length):
        kw[i, n], vw[i, n] = kn[i, 0], vn[i, 0]
    got = decode_attention_plain(*map(torch.from_numpy, (q, kc, vc, kn, vn, length)))
    want = flash_decode_attention(*map(jnp.asarray, (q, kw, vw, length)),
                                  block_k=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=3e-4)


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    """On CPU tensors neither wrapper launches (the counters stay put) and
    each returns exactly its plain version."""
    n1, n2 = flash_attention.launches, decode_attention.launches
    q, k, v = (torch.from_numpy(_np((1, 8, 2, 64), i)) for i in (20, 21, 22))
    torch.testing.assert_close(flash_attention(q, k, v), flash_attention_plain(q, k, v),
                               atol=0, rtol=0)
    args = [torch.from_numpy(_np(s, 23 + i)) for i, s in enumerate(
        [(1, 1, 2, 64), (1, 9, 2, 64), (1, 9, 2, 64), (1, 1, 2, 64), (1, 1, 2, 64)])]
    length = torch.tensor([4], dtype=torch.int32)
    torch.testing.assert_close(decode_attention(*args, length),
                               decode_attention_plain(*args, length), atol=0, rtol=0)
    assert (flash_attention.launches, decode_attention.launches) == (n1, n2)


@pytest.mark.parametrize("kw", [{"window": 4}, {"k_scale": torch.ones(1, 9, 2)},
                                {"v_scale": torch.ones(1, 9, 2)}])
def test_k2_refuses_window_and_scales(kw):
    """K2 serves a window and int8 scales; what it refuses, before any
    dispatch: a window without ``q_pos``, and scales that do not come as a
    pair with an int8 cache."""
    args = [torch.zeros(s) for s in
            [(1, 1, 2, 64), (1, 9, 2, 64), (1, 9, 2, 64), (1, 1, 2, 64), (1, 1, 2, 64)]]
    with pytest.raises(ValueError, match="window|k_scale"):
        decode_attention(*args, torch.tensor([3], dtype=torch.int32), **kw)


def test_kernel_builder_without_cuda_raises_and_builds_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    before = set(kernels.BUILD_DIR.glob("*")) if kernels.BUILD_DIR.exists() else set()
    with pytest.raises(kernels.KernelBuildError, match="CUDA device"):
        kernels.load_library()
    after = set(kernels.BUILD_DIR.glob("*")) if kernels.BUILD_DIR.exists() else set()
    assert after == before


def test_kernel_builder_without_nvcc_raises(monkeypatch, tmp_path):
    """With a CUDA device but no nvcc anywhere, asking for the library
    raises a clear error and compiles nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if (Path("/usr/local/cuda") / "bin" / "nvcc").exists():
        pytest.skip("this machine has nvcc under /usr/local/cuda")
    kernels.load_library.cache_clear()
    try:
        with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
            kernels.load_library()
    finally:
        kernels.load_library.cache_clear()
