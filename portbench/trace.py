"""The traced run's instruments, all from the benchmark's own files:

- a torch.profiler session of device activity around each sample, whose
  kernel, copy and set intervals give the busy time and the kernel time
  by name;
- the host span of every pipeline stage (Pipeline.run_stage wrapped),
  put on the trace's clock by one marker kernel launched at a known host
  time, so that idle gaps are labelled by the stages running then;
- the shape of every call of the three Hopper kernels' wrappers (the
  module attributes the pipeline calls), as chip_smoke.DPCapture takes
  them, so that bounds.py can give each call's least time.
"""

from __future__ import annotations

import collections
import contextlib
import time

SORT_NAMES = ("onesweep_pass_kernel",
              # radix_sort.cu's histogram; row_sort.cu's takes (keys,
              # row_len, spans, positions, ...) and is not the sort's
              "histogram_kernel(unsigned long const*, long, int, unsigned "
              "long")
KERNEL_NAMES = {"radix_sort": SORT_NAMES,
                "banded_bp": ("banded_bp_kernel",),
                "banded_general": ("banded_general_kernel",)}
MARKER = "spin_kernel"          # torch.cuda._sleep's kernel
WRAPPED = (("sort_cuda", "radix_sort", "radix_sort"),
           ("banded_cuda", "banded_align_bp", "banded_bp"),
           ("banded_general_cuda", "banded_align_general", "banded_general"))


def load_kernels():
    """Build (the first run in a checkout) and load the three kernels the
    stages launch, and the native FASTQ reader, before the window."""
    from allpathslg_tpu_torch.native import build as native
    from allpathslg_tpu_torch.ops.cuda import (banded_cuda,
                                               banded_general_cuda,
                                               sort_cuda)

    for mod in (sort_cuda, banded_cuda, banded_general_cuda):
        mod.library()
    native.fastq_lib()


def kernel_of(name: str):
    """The wrapper name a device kernel belongs to, or None."""
    for kernel, names in KERNEL_NAMES.items():
        if any(n in name for n in names):
            return kernel
    return None


class Tracer:
    """Collects, over the samples it wraps: device intervals (start_s,
    end_s, name) on the host's perf_counter clock, stage spans, and the
    kernel calls' shapes."""

    def __init__(self, device: str):
        self.device = device
        self.intervals = []        # (start_s, end_s, name)
        self.spans = []            # (stage, start_s, end_s)
        self.calls = collections.defaultdict(list)
        self.window_s = 0.0
        self.busy_s = 0.0
        self.call_terms = {}       # kernel -> [(bytes, int32 operations)]
        self._windows = []         # each sample's (t0, t1)
        self._saved = []

    # -- wrappers, installed around each sample --
    def _install(self):
        import importlib
        import inspect

        from allpathslg_tpu_torch.pipeline.stages import Pipeline

        for module, attr, kernel in WRAPPED:
            mod = importlib.import_module(
                f"allpathslg_tpu_torch.ops.cuda.{module}")
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(kernel, fn, inspect.signature(fn)))
        run_stage = Pipeline.run_stage
        spans = self.spans

        def traced_stage(pipe, name, *a, **kw):
            t0 = time.perf_counter()
            try:
                return run_stage(pipe, name, *a, **kw)
            finally:
                spans.append((name, t0, time.perf_counter()))

        self._saved.append((Pipeline, "run_stage", run_stage))
        Pipeline.run_stage = traced_stage

    def _remove(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []

    def _wrap(self, kernel, fn, sig):
        calls = self.calls[kernel]

        def wrapped(*args, **kwargs):
            a = sig.bind(*args, **kwargs)
            a.apply_defaults()
            a = a.arguments
            if kernel == "radix_sort":
                keys = a["keys"]
                calls.append(("sort", keys.numel(), keys.element_size()))
            else:
                calls.append(("dp", a["q_len"].clone(), a["offset"].clone(),
                              a["q"].shape[1], a["t"].shape[1], a["band"]))
            return fn(*args, **kwargs)

        return wrapped

    # -- one sample --
    @contextlib.contextmanager
    def sample(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device == "cuda"
        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        self._install()
        prof = profile(activities=acts)
        prof.__enter__()
        try:
            if cuda:
                torch.cuda.synchronize()
            t_mark = time.perf_counter()
            if cuda:
                torch.cuda._sleep(1000)
            t0 = time.perf_counter()
            yield
            t1 = time.perf_counter()
        finally:
            prof.__exit__(None, None, None)
            self._remove()
        self.window_s += t1 - t0
        events = device_events(prof)
        marks = [s for s, _, n in events if MARKER in n]
        shift = (t_mark - marks[0]) if marks else None
        kept = [(s + shift, e + shift, n) for s, e, n in events
                if MARKER not in n] if shift is not None else []
        busy = union_s(kept, t0, t1)
        self.busy_s += busy
        self.intervals += kept
        self._windows.append((t0, t1))

    def finish(self):
        """Bytes and operations of the captured calls (their tensors come
        to the host here, after the window)."""
        from portbench import bounds

        for kernel, calls in self.calls.items():
            terms = []
            for c in calls:
                if c[0] == "sort":
                    terms.append((bounds.sort_bytes(c[1], c[2]), 0))
                else:
                    _, ql, off, Lq, Lt, band = c
                    terms.append(dp_call_terms(kernel, ql.cpu().numpy(),
                                               off.cpu().numpy(), Lq, Lt,
                                               band))
            self.call_terms[kernel] = terms
        self.calls.clear()

    # -- what the readers take --
    def device_s_by_kernel(self) -> dict:
        out = collections.Counter()
        for s, e, n in self.intervals:
            k = kernel_of(n)
            if k:
                out[k] += e - s
        return dict(out)

    def breakdown(self) -> dict:
        by_name = collections.Counter()
        for s, e, n in self.intervals:
            by_name[short_name(n)] += e - s
        idle = collections.Counter()
        edges = sorted({t for _, s, e in self.spans for t in (s, e)})
        for t0, t1 in self._windows:
            for g0, g1 in gaps(self.intervals, t0, t1):
                # a gap split where a stage starts or ends inside it
                cuts = [g0, *(t for t in edges if g0 < t < g1), g1]
                for a, b in zip(cuts, cuts[1:]):
                    idle[self.label((a + b) / 2)] += b - a
        return {"device_ops": [[n, v] for n, v in by_name.most_common(10)],
                "idle_gaps": [[n, v] for n, v in idle.most_common(10)]}

    def label(self, t: float) -> str:
        running = sorted({n for n, s, e in self.spans if s <= t < e})
        return "+".join(running) if running else "outside stages"


def dp_call_terms(kernel, ql, off, Lq, Lt, band):
    from portbench import bounds

    per_row = (bounds.BP_OPS_PER_ROW if kernel == "banded_bp"
               else (2 * band + 1) * bounds.GENERAL_OPS_PER_SLOT)
    return bounds.dp_terms(ql, off, Lq, Lt, band, per_row)


def short_name(name: str) -> str:
    """A kernel's name without its return type, argument list and the
    namespaces of torch and of the port's kernels; template arguments
    stay (they name an elementwise kernel's functor)."""
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    head = name[:cut].removeprefix("void ")
    for ns in ("at::native::", "(anonymous namespace)::", "at::cuda::"):
        head = head.replace(ns, "")
    return head[:120]


def device_events(prof) -> list:
    """[(start_s, end_s, name)] of the session's device activity (kernels,
    copies, sets), on the profiler's clock in seconds."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        else:
            s, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
        out.append((s, s + d, e.name()))
    return out


def merged(intervals, t0, t1) -> list:
    """The union of the intervals inside [t0, t1], as sorted disjoint
    (start, end)."""
    out = []
    for s, e, _ in sorted(intervals):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_s(intervals, t0, t1) -> float:
    return float(sum(e - s for s, e in merged(intervals, t0, t1)))


def gaps(intervals, t0, t1) -> list:
    """The idle stretches of [t0, t1] between the merged intervals."""
    out, at = [], t0
    for s, e in merged(intervals, t0, t1):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if t1 > at:
        out.append((at, t1))
    return out


def roofline_pct(tracer: Tracer, kernel: str, peak: dict):
    """100 x (the least time of the kernel's captured calls) / (its device
    time by name), or None when either is missing."""
    from portbench import bounds

    if peak is None:
        return None
    terms = tracer.call_terms.get(kernel)
    device_s = tracer.device_s_by_kernel().get(kernel)
    if not terms or not device_s:
        return None
    least = sum(bounds.bound_s(b, o, peak) for b, o in terms)
    return 100.0 * least / device_s
