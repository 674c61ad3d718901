"""Kernel launch counts.

Each kernel wrapper records one launch where it launches its kernel, and
nowhere else. A launch is counted under the pipeline stage that the
launching thread runs (`stage`, set by Pipeline.run_stage), so the
launches of stages that run at the same time in the stage DAG stay apart.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict, Optional

_local = threading.local()
_lock = threading.Lock()
_counts: collections.Counter = collections.Counter()  # (kernel, stage) -> n


def record(kernel: str) -> None:
    with _lock:
        _counts[(kernel, current_stage())] += 1


def count(kernel: str) -> int:
    """Launches of `kernel` since its last reset, over all stages."""
    with _lock:
        return sum(n for (k, _), n in _counts.items() if k == kernel)


def reset(kernel: Optional[str] = None) -> None:
    """Zero the counts of `kernel` (of every kernel when None)."""
    with _lock:
        for key in [key for key in _counts if kernel in (None, key[0])]:
            del _counts[key]


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
