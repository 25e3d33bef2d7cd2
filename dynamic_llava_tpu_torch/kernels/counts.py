"""Launches of the hand-written kernels on the card, counted without a trace.

Each kernel wrapper calls ``launched(entry)`` right after its C entry point
``entry`` has launched its kernel and reported no error: one wrapper call,
one C call, one launch of the kernel the entry is named for (the names of
``chip_smoke.py``'s ``kernels`` line: ``flash_attention_fwd``,
``decode_attention_appended``, ``extend_attention_appended``,
``flash_attention_bwd_dq`` / ``_dkv`` / ``_delta``,
``flash_policy_attention_fwd``, ``q8_gemv`` / ``q8_gemv_group``,
``q4_gemv`` / ``q4_gemv_group``, ``q4_mlp``).

Outside a CUDA-graph capture that is a launch on the card: ``COUNTS[entry]``
grows by one. Inside a capture the kernel is only recorded into the graph,
and it runs once each time the graph is replayed. A runner opens
``capture()`` around its capture and gets the launches recorded in it (also
added to ``CAPTURED``, the captures counted apart); each replay of that
graph calls ``replayed`` with them, which adds them to ``COUNTS``. So
``COUNTS`` holds the eager launches plus, for each graph, the launches in
its capture times its replays. A capture that no ``capture()`` wraps (a
timing graph) adds its launches to ``CAPTURED`` only.

Outside ``counting()`` nothing is counted, but a capture records what it
holds whether counting is on or off, so the replays of a graph captured
before counting began are counted too. The port launches on one stream a
device and never captures from two threads at once, so one set of counters
serves every thread.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Iterator, List

import torch

COUNTS: Counter = Counter()  # launches on the card, by C entry point
CAPTURED: Counter = Counter()  # launches recorded into CUDA graphs by captures
_on = False
_open: List[Counter] = []  # the launches of each capture open now, innermost last


def launched(entry: str) -> None:
    """One launch of ``entry``'s kernel (a wrapper calls this after its C
    entry point returned without error)."""
    if _open:
        _open[-1][entry] += 1
        if _on:
            CAPTURED[entry] += 1
        return
    if not _on:
        return
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        CAPTURED[entry] += 1
        return
    COUNTS[entry] += 1


def replayed(captured: Counter) -> None:
    """A graph whose capture recorded ``captured`` ran once more."""
    if _on:
        COUNTS.update(captured)


@contextlib.contextmanager
def capture() -> Iterator[Counter]:
    """Around a CUDA-graph capture: yields the ``Counter`` of the launches
    recorded in it, filled as the capture runs."""
    launches: Counter = Counter()
    _open.append(launches)
    try:
        yield launches
    finally:
        _open.remove(launches)


@contextlib.contextmanager
def counting() -> Iterator[Counter]:
    """Zero ``COUNTS`` and ``CAPTURED``, count launches in the block, and
    stop at its end; yields ``COUNTS`` (read it after the block). Counting
    blocks do not nest: an inner one would zero the outer one's counts."""
    global _on
    if _on:
        raise RuntimeError("kernels.counts.counting: already counting")
    COUNTS.clear()
    CAPTURED.clear()
    _on = True
    try:
        yield COUNTS
    finally:
        _on = False
