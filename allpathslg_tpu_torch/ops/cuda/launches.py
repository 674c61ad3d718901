"""Kernel launch counts.

Each kernel wrapper records one launch where it launches its kernel, and
nowhere else. A launch is counted under the pipeline stage that the
launching thread runs (`stage`, set by Pipeline.run_stage), so the
launches of stages that run at the same time in the stage DAG stay apart.
A wrapper may also give the size of the call (the radix sort gives its key
count); sizes are kept beside the counts as a histogram by power of two:
bucket b holds the calls of 2**(b-1) <= size < 2**b.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict, Optional

_local = threading.local()
_lock = threading.Lock()
_counts: collections.Counter = collections.Counter()  # (kernel, stage) -> n
_sizes: collections.Counter = collections.Counter()   # (kernel, stage, b) -> n


def record(kernel: str, size: Optional[int] = None) -> None:
    with _lock:
        stage_ = current_stage()
        _counts[(kernel, stage_)] += 1
        if size is not None:
            _sizes[(kernel, stage_, int(size).bit_length())] += 1


def count(kernel: str) -> int:
    """Launches of `kernel` since its last reset, over all stages."""
    with _lock:
        return sum(n for (k, _), n in _counts.items() if k == kernel)


def reset(kernel: Optional[str] = None) -> None:
    """Zero the counts of `kernel` (of every kernel when None)."""
    with _lock:
        for table in (_counts, _sizes):
            for key in [key for key in table if kernel in (None, key[0])]:
                del table[key]


def size_histogram(kernel: str) -> Dict[str, int]:
    """{"<2**b": calls of 2**(b-1) <= size < 2**b} of `kernel` since its
    last reset, over all stages, in increasing b."""
    hist: collections.Counter = collections.Counter()
    with _lock:
        for (k, _, b), n in _sizes.items():
            if k == kernel:
                hist[b] += n
    return {f"<2**{b}": hist[b] for b in sorted(hist)}


def by_stage() -> Dict[Optional[str], Dict[str, int]]:
    """{stage: {kernel: launches}}; launches outside a stage are under
    None."""
    out: Dict[Optional[str], Dict[str, int]] = {}
    with _lock:
        for (k, s), n in _counts.items():
            out.setdefault(s, {})[k] = n
    return out


def current_stage() -> Optional[str]:
    """The stage this thread's launches are counted under (None outside
    one)."""
    return getattr(_local, "stage", None)


@contextlib.contextmanager
def stage(name: str):
    """Count this thread's launches under stage `name` inside the block."""
    prev = getattr(_local, "stage", None)
    _local.stage = name
    try:
        yield
    finally:
        _local.stage = prev
