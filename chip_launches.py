"""The launch bookkeeping of ``chip_smoke.py``: the script's one
launch-counting trace, held against the launch counter, and the phases whose
launches on the card are counted over the whole phase.

The counter (``dynamic_llava_tpu_torch/kernels/counts.py``) counts each
kernel wrapper's launches on the card, and a CUDA graph's captured launches
once a replay; ``kernel_cases.counted_launches`` reads it over a call, by
serving-kernel label (``kernel_cases.COUNTED``: a label and the wrappers of
the ``kernels`` line that launch its kernel). ``chip_smoke.py`` imports this
module once the port is importable; nothing here touches CUDA on import.
"""

from __future__ import annotations


def counted_against_trace(kc, fn, what: str):
    """``(fn(), launches, hold)``: ``fn``'s launches on the card by the
    counter, inside a ``torch.profiler`` trace of the same call
    (``kc.device_launches``), which must count the same launches of every
    serving kernel; ``hold`` is both counts."""
    (out, seen), traced = kc.device_launches(lambda: kc.counted_launches(fn))
    if seen != traced:
        raise RuntimeError(f"{what}: the launch counter gave {seen}, the trace {traced} for "
                           "the same call")
    return out, seen, dict(counted=seen, traced=traced)


class CountedPhases:
    """Phases whose main path is the whole phase: each one's launches on the
    card, counted over it, by serving-kernel label."""

    def __init__(self, kc, log):
        self.kc, self.log = kc, log
        self.seen = {}  # phase name -> launches by label

    def run(self, name: str, fn):
        """``fn()``, its launches on the card kept under ``name``."""
        out, seen = self.kc.counted_launches(fn)
        self.seen[name] = seen
        self.log(f"  phase {name}: launches on the card {seen}")
        return out

    def add_to(self, launches: dict) -> int:
        """Add every phase's launches to ``launches`` (by the ``kernels``
        line's names: a GEMV and its group form launch one kernel, and both
        report it); returns the M-query kernel's (K2-M) launches over the
        phases."""
        for seen in self.seen.values():
            for label, names in self.kc.COUNTED.items():
                for name in names:
                    launches[name] += seen[label]
        return sum(seen["extend_kernel"] for seen in self.seen.values())
