"""Spans, counters and kernel launch counts of the port.

Launch counts are always on. Each kernel wrapper records one launch where
it launches its kernel (`record(kernel)`), and nowhere else. A launch is
counted under the pipeline stage that the launching thread runs (`stage`,
entered by Pipeline.run_stage), so the launches of stages that run at the
same time in the stage DAG stay apart. A wrapper may also give the size of
the call (the radix sort gives its key count); sizes are kept beside the
counts as a histogram by power of two: bucket b holds the calls of
2**(b-1) <= size < 2**b.

Spans are recorded only while a torch.profiler session is open in the
process: `span` reads the flag torch.profiler sets once, when the span is
entered, and outside a session returns one shared no-op context. A span
holds its name, its start and end on time.perf_counter() (the clock the
benchmark's tracer shifts the device trace onto), the native id of its
thread, its parent span, its run (the run dir's path, inherited from the
parent when not given), its attributes and its counters (`add`). Spans
are kept in memory until `clear()`; nothing is written out during a run.
A span makes no profiler event of its own: `merge_chrome_trace` adds the
spans of a session to the Chrome trace it exported, as "X" events.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

_local = threading.local()
_lock = threading.Lock()
_counts: collections.Counter = collections.Counter()  # (kernel, stage) -> n
_sizes: collections.Counter = collections.Counter()   # (kernel, stage, b) -> n
_spans: List["Span"] = []
STAGE_PREFIX = "stage."


def _open() -> list:
    """This thread's open spans, innermost last."""
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


class Span:
    """One recorded interval; `with span(...)` opens and closes it."""

    __slots__ = ("name", "t0", "t1", "thread", "parent", "run", "attrs",
                 "counters")

    def __init__(self, name: str, run, attrs: dict):
        self.name = name
        self.run = run
        self.attrs = attrs
        self.counters: Dict[str, int] = {}
        self.t0 = self.t1 = None
        self.thread = self.parent = None

    def _place(self):
        stack = _open()
        self.parent = stack[-1] if stack else None
        if self.run is None and self.parent is not None:
            self.run = self.parent.run
        self.thread = threading.get_native_id()
        return stack

    def __enter__(self) -> "Span":
        self._place().append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        stack = _open()
        if stack and stack[-1] is self:
            stack.pop()
        with _lock:
            _spans.append(self)
        return False

    def add(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + int(n)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def took(self) -> str:
        """The span's duration for a log line."""
        return f"{self.seconds:.1f}s"


class _NoSpan:
    """What `span` returns outside a profiler session: records nothing."""

    __slots__ = ()
    took = "untraced"

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, counter: str, n: int = 1) -> None:
        pass


NO_SPAN = _NoSpan()


def span(name: str, run: Optional[str] = None, **attrs):
    """A context that records span `name` while a profiler session is
    open, and the shared no-op NO_SPAN otherwise."""
    if not _profiler._is_profiler_enabled:
        return NO_SPAN
    return Span(name, run, attrs)


def add(counter: str, n: int = 1) -> None:
    """Adds n to `counter` of this thread's innermost open span."""
    stack = getattr(_local, "open", None)
    if stack:
        stack[-1].add(counter, n)


def record(name: str, t0: float = None, t1: float = None, *,
           size: Optional[int] = None, run: Optional[str] = None,
           **attrs) -> None:
    """With t0 and t1 (perf_counter seconds): the interval `name` measured
    elsewhere, such as a wait, recorded as a span of this thread when a
    profiler session is open. Without them: one launch of kernel `name`,
    counted under this thread's stage (and on its stage span)."""
    if t0 is not None:
        if not _profiler._is_profiler_enabled:
            return
        s = Span(name, run, attrs)
        s._place()
        s.t0, s.t1 = t0, t1
        with _lock:
            _spans.append(s)
        return
    with _lock:
        stage_ = current_stage()
        _counts[(name, stage_)] += 1
        if size is not None:
            _sizes[(name, stage_, int(size).bit_length())] += 1
    for s in reversed(getattr(_local, "open", None) or ()):
        if s.name.startswith(STAGE_PREFIX):
            s.add(f"launches.{name}")
            break


def spans() -> List[Span]:
    """The spans recorded since the last clear(), in the order they
    ended."""
    with _lock:
        return list(_spans)


def clear() -> None:
    """Drops the recorded spans."""
    with _lock:
        _spans.clear()


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


class stage:
    """Counts this thread's launches under stage `name` inside the block,
    and records the span `stage.<name>` there."""

    def __init__(self, name: str, run: Optional[str] = None):
        self.name = name
        self._span = span(STAGE_PREFIX + name, run)

    def __enter__(self):
        self._prev = getattr(_local, "stage", None)
        _local.stage = self.name
        return self._span.__enter__()

    def __exit__(self, *exc) -> bool:
        _local.stage = self._prev
        return self._span.__exit__(*exc)


# ---- Chrome traces ----------------------------------------------------------

def mark() -> float:
    """Runs one small torch op on this thread and returns the perf_counter
    time just before it: inside a profiler session with CPU activity, the
    op's event ("aten::empty", this thread's first) places the session's
    clock against perf_counter (`merge_chrome_trace`)."""
    import torch

    t = time.perf_counter()
    torch.empty(0)
    return t


def merge_chrome_trace(path: str, t_mark: float, t_end: float,
                       thread: int) -> None:
    """Adds the spans that started in [t_mark, t_end] to the Chrome trace
    at `path`, which torch.profiler exported from a session in which
    `mark()` ran on thread `thread` (native id) at t_mark."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    marks = [e for e in events if e.get("name") == "aten::empty"
             and e.get("tid") == thread and e.get("ph") == "X"]
    if not marks:
        raise ValueError(f"{path}: no marker event on thread {thread}")
    first = min(marks, key=lambda e: e["ts"])
    shift_us = first["ts"] - t_mark * 1e6
    got = [s for s in spans() if t_mark <= s.t0 <= t_end]
    events += [{"ph": "X", "cat": "span", "name": s.name,
                "ts": s.t0 * 1e6 + shift_us, "dur": (s.t1 - s.t0) * 1e6,
                "pid": first["pid"], "tid": s.thread,
                "args": {"run": s.run, **s.attrs, **s.counters}}
               for s in got]
    with open(path, "w") as f:
        json.dump(doc, f)
