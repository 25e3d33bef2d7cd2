"""Build and load the hand-written Hopper kernels.

The CUDA C++ sources under ``dynamic_llava_tpu_torch/csrc/`` are compiled
with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all started
together) and linked into ONE shared library with a plain C interface, at
first use, and loaded with ``ctypes``. Tensor pointers and
the CUDA stream cross the boundary as ``c_void_p``; every entry point
returns ``cudaGetLastError()`` after its launch and ``check`` raises on a
non-zero code.

Nothing is compiled, loaded or imported from CUDA when this module is
imported: the CPU test suite imports every module on machines that have
neither ``nvcc`` nor a card. The library lands in ``_build/`` beside the
package (git-ignored), named by a hash of the sources and flags, so an
edited kernel is rebuilt and an unchanged one is reused within a checkout.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# dtype codes shared with the C entry points (see csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class KernelBuildError(RuntimeError):
    """The kernels cannot be built or loaded on this machine."""


class Library(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when a library from an earlier build was reused
    ptxas_log: str


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises ``KernelBuildError`` when there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.is_file() and os.access(cand, os.X_OK):
                return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels are built from source at first use and "
        "need the CUDA toolkit"
    )


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [
        p, p, p, p, p, p,  # q, k, v, kv_length, out, lse
        i, i, i, i, i, i,  # B, Sq, Sk, H, Hkv, D
        i, i, f, i, p,  # causal, q_offset, scale, dtype, stream
    ]
    lib.flash_attention_fwd.restype = i
    lib.decode_attention_workspace_bytes.argtypes = [i, i, i, i, i, i]  # B, M, H, Hkv, D, n_split
    lib.decode_attention_workspace_bytes.restype = ctypes.c_longlong
    lib.extend_attention_workspace_bytes.argtypes = [i] * 8  # ... n_split, q dtype, storage
    lib.extend_attention_workspace_bytes.restype = ctypes.c_longlong
    lib.decode_attention_appended.argtypes = [
        p, p, p, p, p, p,  # q, k_cache, v_cache, k_cur, v_cur, bound
        p, p, p, p,  # k_scale, v_scale, q_pos (each may be null), out
        p, ctypes.c_longlong, p, i,  # workspace, its bytes, tickets (null at n_split 1), n_split
        i, i, i, i, i,  # B, max_len, H, Hkv, D
        f, i, i, i, p,  # scale, window (0 = none), q dtype, storage code, stream
    ]
    lib.decode_attention_appended.restype = i
    lib.extend_attention_appended.argtypes = [
        p, p, p, p, p, p,  # q, k_cache, v_cache, k_chunk, v_chunk, bound
        p, p, p, p, p,  # k_scale, v_scale, q_pos, attend (each may be null), out
        p, ctypes.c_longlong, p, i,  # workspace, its bytes, tickets (null at n_split 1), n_split
        i, i, i, i, i, i,  # B, M, max_len, H, Hkv, D
        f, i, i, i, p,  # scale, window (0 = none), q dtype, storage code, stream
    ]
    lib.extend_attention_appended.restype = i
    bwd = [
        p, p, p, p, p, p, p,  # q, k, v, dout, lse, delta, kv_length
    ]
    shape = [i, i, i, i, i, i, i, f, i, p]  # B, Sq, Sk, H, Hkv, D, causal, scale, dtype, stream
    lib.flash_attention_bwd_dq.argtypes = [*bwd, p, *shape]  # + dq
    lib.flash_attention_bwd_dq.restype = i
    lib.flash_attention_bwd_dkv.argtypes = [*bwd, p, p, *shape]  # + dk, dv
    lib.flash_attention_bwd_dkv.restype = i
    lib.flash_attention_bwd_delta.argtypes = [
        p, p, p,  # out, dout, delta
        i, i, i, i, i, p,  # B, Sq, H, D, dtype, stream
    ]
    lib.flash_attention_bwd_delta.restype = i
    lib.flash_policy_attention_fwd.argtypes = [
        p, p, p, p, p, p,  # q, k, v, policy, vsum scratch, out
        i, i, i, i, i,  # B, S, H, Hkv, D
        f, f, i, p,  # scale, eps, dtype, stream
    ]
    lib.flash_policy_attention_fwd.restype = i
    ll = ctypes.c_longlong
    tail = [i, i, i, i, i, i, p]  # N, rows, K, x/s/y dtype, stream
    scratch = [p, ll, p]  # scratch, its bytes, tickets (bf16 x; else null)
    for name in ("q8_gemv", "q4_gemv"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, *scratch, *tail]  # x, w, s, y
        fn.restype = i
    for name in ("q8_gemv_group", "q4_gemv_group"):
        fn = getattr(lib, name)
        fn.argtypes = [
            p, p, p, p, p, p, p, p, p, p,  # x, w0-2, s0-2, y0-2
            *scratch,
            i, i, i, i,  # n0-2, nw
            *tail[1:],  # rows, K, x/s/y dtype, stream
        ]
        fn.restype = i
    lib.quant_gemv_scratch_bytes.argtypes = [i, i, i, i, i, i, i]  # n0-2, nw, rows, K, int4
    lib.quant_gemv_scratch_bytes.restype = ll
    lib.q4_mlp_scratch_bytes.argtypes = [i, i, i, i]  # rows, K, F, D
    lib.q4_mlp_scratch_bytes.restype = ll
    lib.q4_mlp.argtypes = [
        p, p, p, p, p, p, p, p,  # x, gate, up, down, gate/up/down scales, y
        p, ll, p,  # scratch, its bytes, tickets
        i, i, i, i, i, i, i, p,  # rows, K, F, D, x/s/y dtype, stream
    ]
    lib.q4_mlp.restype = i
    lib.kernel_error_string.argtypes = [i]
    lib.kernel_error_string.restype = ctypes.c_char_p


def _build(nvcc: str, sources, path: Path):
    """Compile every source to an object file, all ``nvcc`` processes
    running at once, then link them into ``path``. Returns (seconds, the
    compilers' output)."""
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.tmp"
    t0 = time.perf_counter()
    try:
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)
        ]
        outs = [proc.communicate()[0] for proc in procs]  # reaps every process
        log = "".join(outs)
        failed = [(src, proc.returncode) for src, proc in zip(sources, procs)
                  if proc.returncode != 0]
        if failed:
            raise KernelBuildError(f"nvcc failed for {failed}:\n{log}")
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise KernelBuildError(
                f"nvcc link failed ({res.returncode}):\n{' '.join(link)}\n"
                f"{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return time.perf_counter() - t0, log


@functools.cache
def load_library() -> Library:
    """Build (if needed) and load the kernel library. Raises
    ``KernelBuildError`` without building anything when there is no CUDA
    device or no ``nvcc``."""
    if not torch.cuda.is_available():
        raise KernelBuildError(
            "the CUDA kernels need a CUDA device, and "
            "torch.cuda.is_available() is False"
        )
    nvcc = find_nvcc()
    sources = [s for s in _sources() if s.suffix == ".cu"]
    if not sources:
        raise KernelBuildError(f"no CUDA sources under {CSRC_DIR}")
    path = BUILD_DIR / f"libdllava_kernels_{_digest()}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        seconds, log = _build(nvcc, sources, path)
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    return Library(lib=lib, path=path, build_seconds=seconds, ptxas_log=log)


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its return value is
    ``cudaGetLastError()`` right after the launch)."""
    if code != 0:
        msg = load_library().lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


# zeroed int32 tickets by device: a kernel that sums partial results in its
# last block to arrive (csrc/common.cuh last_block_to_arrive) leaves them
# zero, so launches in stream order share one buffer
TICKETS = 4096
_tickets = {}


def tickets(t: torch.Tensor, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 tickets on ``t``'s device. One buffer a
    device serves every launch, eager or captured in a CUDA graph (the
    kernels leave it zero), so launches that use it must not overlap: the
    port launches on one stream a device. Inside a CUDA-graph capture a
    buffer not yet cached is zeroed anew (a memset node of that graph) and
    not kept, so no tensor of a graph's private pool outlives its capture
    here."""
    if n > TICKETS:
        raise ValueError(f"{n} tickets asked for, at most {TICKETS}")
    buf = _tickets.get(t.device)
    if buf is None:
        buf = torch.zeros(TICKETS, dtype=torch.int32, device=t.device)
        if not torch.cuda.is_current_stream_capturing():
            _tickets[t.device] = buf
    return buf


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
