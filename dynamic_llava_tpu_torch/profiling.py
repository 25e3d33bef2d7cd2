"""Device-memory accounting: the port's counterpart of
``dynamic_llava_tpu/profiling.py`` (the reference's CUDA measurement
protocol: ``max_memory_allocated`` and the peak-minus-model split of
``dynamic_llava_image_time_and_mem.py``).

On the card every number comes from PyTorch's caching allocator:

* ``device_memory_stats`` is ``torch.cuda.memory_stats`` (``{}`` on the
  CPU, as the JAX function returns ``{}`` where the backend has none);
* ``live_device_bytes`` is ``torch.cuda.memory_allocated``: the bytes of
  every live tensor on the card;
* ``memory_report``'s peak is the allocator's high-water mark,
  ``torch.cuda.max_memory_allocated`` (reset it with
  ``torch.cuda.reset_peak_memory_stats``). XLA's per-program memory
  analysis (``program_memory``, ``programs_gb``) has no counterpart: a
  PyTorch program's workspace is whatever the allocator handed out, which
  the peak already holds.

On the CPU there is no allocator count: ``live_device_bytes`` sums the
distinct storages of the CPU tensors that Python holds (the JAX function
sums ``jax.live_arrays()``), and the peak estimate is that sum.
"""

from __future__ import annotations

import gc
from typing import Any, Dict

import torch

GB = float(1 << 30)

# torch.cuda.memory_stats keys of the allocated bytes now and at the peak
CURRENT_KEY = "allocated_bytes.all.current"
PEAK_KEY = "allocated_bytes.all.peak"


def _first_tensor(tree: Any):
    if isinstance(tree, torch.Tensor):
        return tree
    values = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for v in values:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def resolve(device=None, model_params: Any = None) -> torch.device:
    """``device``, else the device of ``model_params``' tensors, else the
    card (``weights.resolve_device``: raises where there is none)."""
    if device is None and model_params is not None:
        leaf = _first_tensor(model_params)
        if leaf is not None:
            return leaf.device
    from .weights import resolve_device

    return resolve_device(device)


def device_memory_stats(device=None) -> Dict[str, int]:
    """The allocator's raw stats on a CUDA device (``torch.cuda.memory_stats``);
    ``{}`` on the CPU."""
    dev = resolve(device)
    if dev.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(dev))


def live_device_bytes(device=None) -> int:
    """Bytes of the live tensors on ``device``: the allocator's count on
    the card; on the CPU the distinct storages of the tensors Python holds."""
    dev = resolve(device)
    if dev.type == "cuda":
        return int(torch.cuda.memory_allocated(dev))
    seen, total = set(), 0
    for obj in gc.get_objects():
        # by type: isinstance would read __class__, which some deprecated
        # module proxies answer with a warning
        if not issubclass(type(obj), torch.Tensor) or obj.device != dev \
                or obj.layout != torch.strided:
            continue
        try:
            storage = obj.untyped_storage()
        except (RuntimeError, NotImplementedError):
            continue
        if storage.data_ptr() not in seen:
            seen.add(storage.data_ptr())
            total += storage.nbytes()
    return total


def tree_bytes(tree: Any) -> int:
    """Bytes of the tensors in a pytree of dicts, lists and tuples (a param
    tree: "model memory"; a quantized leaf is a dict of its tensors); other
    leaves count 0, as in the JAX function."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def memory_report(device=None, model_params: Any = None) -> Dict[str, float]:
    """One snapshot in GB, the reference's peak-minus-model split:
    ``live_bytes_gb``; with ``model_params`` ``model_bytes_gb`` and
    ``non_model_live_gb``; ``peak_est_gb`` (the allocator's peak on the
    card, the live bytes on the CPU); and on the card ``bytes_in_use_gb``
    and ``peak_bytes_gb``. ``device`` defaults to the params' device."""
    dev = resolve(device, model_params)
    stats = device_memory_stats(dev)
    live = live_device_bytes(dev)
    report: Dict[str, float] = {"live_bytes_gb": round(live / GB, 4)}
    if model_params is not None:
        model = tree_bytes(model_params)
        report["model_bytes_gb"] = round(model / GB, 4)
        report["non_model_live_gb"] = round((live - model) / GB, 4)
    peak = max(live, stats.get(PEAK_KEY, 0))
    report["peak_est_gb"] = round(peak / GB, 4)
    if stats:
        report["bytes_in_use_gb"] = round(stats.get(CURRENT_KEY, 0) / GB, 4)
        report["peak_bytes_gb"] = round(stats.get(PEAK_KEY, 0) / GB, 4)
    return report
