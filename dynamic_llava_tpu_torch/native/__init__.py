"""Native (C++) host-side image ops, loaded with ctypes: the port's own copy
of ``dynamic_llava_tpu/native``.

``image_ops.cpp`` is built with ``g++`` at first use into the package's
``_build/`` directory, under a name that carries a digest of the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded. Each build writes a file of its own and renames it into place, so
that processes building at once never load a half-written library. Where
``g++`` is missing or the build fails, ``native_available()`` is False and
the data pipeline takes the PIL path (``mm_utils``) instead. This is host
preprocessing, not a device kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "image_ops.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
# the JAX package's flags: both libraries compute the same bits
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libimage_ops_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    """Compile to a file of this process and thread, then rename it to
    ``path``. False where ``g++`` is missing or fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


@functools.cache
def load_image_ops() -> Optional[ctypes.CDLL]:
    """Build (once) and load the native library; None if unavailable."""
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    lib = ctypes.CDLL(str(path))
    p = ctypes.POINTER
    lib.clip_preprocess_batch.argtypes = [
        p(ctypes.c_uint8), p(ctypes.c_int64), p(ctypes.c_int), p(ctypes.c_int),
        ctypes.c_int, ctypes.c_int,
        p(ctypes.c_float), p(ctypes.c_float), p(ctypes.c_float), p(ctypes.c_float),
    ]
    lib.clip_preprocess_batch.restype = None
    return lib


def native_available() -> bool:
    return load_image_ops() is not None


def clip_preprocess_batch_native(
    images: List[np.ndarray],  # list of uint8 [h, w, 3]
    out_size: int,
    background: Sequence[float],  # RGB 0..255
    mean: Sequence[float],
    std: Sequence[float],
) -> np.ndarray:
    """Fused pad-to-square + bicubic + normalize for a ragged image batch.
    Returns fp32 [n, out_size, out_size, 3] (NHWC). Each call adds one to
    ``clip_preprocess_batch_native.calls``."""
    lib = load_image_ops()
    if lib is None:
        raise RuntimeError("native image ops unavailable (no g++?)")
    for im in images:
        if im.ndim != 3 or im.shape[2] != 3 or im.dtype != np.uint8:
            raise ValueError(f"expected uint8 [h, w, 3] images, got {im.dtype} {im.shape}")
    n = len(images)
    flat = np.ascontiguousarray(np.concatenate([im.reshape(-1) for im in images]))
    sizes = np.asarray([im.size for im in images], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    heights = np.asarray([im.shape[0] for im in images], np.int32)
    widths = np.asarray([im.shape[1] for im in images], np.int32)
    out = np.empty((n, out_size, out_size, 3), np.float32)
    bg = np.asarray(background, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    lib.clip_preprocess_batch(
        ptr(flat, ctypes.c_uint8), ptr(offsets, ctypes.c_int64),
        ptr(heights, ctypes.c_int), ptr(widths, ctypes.c_int),
        n, out_size,
        ptr(bg, ctypes.c_float), ptr(mean, ctypes.c_float),
        ptr(std, ctypes.c_float), ptr(out, ctypes.c_float),
    )
    clip_preprocess_batch_native.calls += 1
    return out


clip_preprocess_batch_native.calls = 0
