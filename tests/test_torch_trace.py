"""The port's spans and counters (allpathslg_tpu_torch/trace.py): off and
free outside a torch.profiler session, recorded inside one (nesting,
parent, thread, run, counters), on torch's own profiler flag; the
pipeline's artifacts the same with spans on and off; run_full's DAG waits
and stages recorded under stage_workers=2; profile_dir's traces holding
the spans on the trace's clock."""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import profiler as autograd_profiler  # noqa: E402

from allpathslg_tpu_torch import trace  # noqa: E402
from allpathslg_tpu_torch.pipeline.config import AssemblyConfig  # noqa: E402
from allpathslg_tpu_torch.pipeline.run import prepare_sim_inputs  # noqa: E402
from allpathslg_tpu_torch.pipeline.rundir import RunDir  # noqa: E402
from allpathslg_tpu_torch.pipeline.stages import Pipeline  # noqa: E402

torch.set_num_threads(2)
CPU = [torch.profiler.ProfilerActivity.CPU]
SIM = (6000, 30.0, 0.005, 100, 4)
CFG = dict(K=48, batch_reads=4096, evaluation="NONE")


def profiled():
    return torch.profiler.profile(activities=CPU)


@pytest.fixture(autouse=True)
def no_spans():
    trace.clear()
    yield
    trace.clear()


def test_spans_record_nothing_outside_a_profiler():
    s = trace.span("x", run="r", k=1)
    assert s is trace.NO_SPAN and trace.span("y") is s
    with s as got:
        got.add("n", 3)
        trace.add("n", 3)
        trace.record("wait", 1.0, 2.0)
        with trace.stage("st") as st:
            assert st is trace.NO_SPAN
            assert trace.current_stage() == "st"
    assert trace.current_stage() is None
    assert trace.spans() == []


def test_torch_profiler_flag_flips():
    """The flag spans read is torch's: a torch that renames it or stops
    setting it fails here, not silently."""
    assert autograd_profiler._is_profiler_enabled is False
    with profiled():
        assert autograd_profiler._is_profiler_enabled is True
        assert trace.span("x") is not trace.NO_SPAN
    assert autograd_profiler._is_profiler_enabled is False
    assert trace.span("x") is trace.NO_SPAN


def test_spans_inside_a_cpu_profiler():
    other = {}

    def worker():
        with trace.span("worker", run="r2") as w:
            w.add("items", 2)
        other["thread"] = threading.get_native_id()

    with profiled():
        with trace.stage("s1", run="r1") as st:
            with trace.span("outer", step=1) as outer:
                trace.add("c", 2)
                trace.record("k_span_test")       # a launch
                with trace.span("inner") as inner:
                    trace.add("c", 5)
                    time.sleep(0.002)
                t = time.perf_counter()
                trace.record("wait", t - 0.5, t, stage="s1")
            t_ = threading.Thread(target=worker)
            t_.start()
            t_.join()
    trace.reset("k_span_test")
    got = {s.name: s for s in trace.spans()}
    assert set(got) == {"stage.s1", "outer", "inner", "wait", "worker"}
    me = threading.get_native_id()
    assert got["outer"] is outer and got["inner"] is inner
    assert inner.parent is outer and outer.parent is st
    assert got["wait"].parent is outer and st.parent is None
    assert got["worker"].parent is None
    assert {s.run for n, s in got.items() if n != "worker"} == {"r1"}
    assert got["worker"].run == "r2"
    assert got["worker"].thread == other["thread"] != me
    assert all(s.thread == me for n, s in got.items() if n != "worker")
    assert outer.counters == {"c": 2} and inner.counters == {"c": 5}
    assert st.counters == {"launches.k_span_test": 1}
    assert got["worker"].counters == {"items": 2}
    assert outer.attrs == {"step": 1} and got["wait"].attrs == {"stage": "s1"}
    assert outer.t0 <= inner.t0 < inner.t1 <= outer.t1
    assert inner.seconds >= 0.002
    assert got["wait"].t1 - got["wait"].t0 == pytest.approx(0.5)
    trace.clear()
    assert trace.spans() == []


def _artifacts(rd):
    out = {}
    for name in sorted(rd.manifest["stages"]):
        for art in rd.manifest["stages"][name]["outputs"]:
            stem = art.rsplit(".", 1)[0]
            if art.endswith(".npz") and rd.has(stem):
                for k, v in rd.load_arrays(stem).items():
                    out[(stem, k)] = v.tobytes()
            else:
                with open(rd.file_path(art), "rb") as f:
                    out[art] = f.read()
    return out


def test_contig_slice_artifacts_same_with_spans_on_and_off(tmp_path):
    runs = {}
    for tag in ("off", "on"):
        rd = RunDir(str(tmp_path / tag))
        prepare_sim_inputs(rd, *SIM, lambda *a: None)
        pipe = Pipeline(rd, AssemblyConfig.from_overrides(**CFG),
                        lambda *a: None, device="cpu")
        if tag == "on":
            with profiled():
                pipe.run_contig_slice()
        else:
            pipe.run_contig_slice()
        runs[tag] = _artifacts(rd)
        assert bool(trace.spans()) == (tag == "on")
    assert runs["on"].keys() == runs["off"].keys()
    assert "unibases.fasta" in runs["on"]
    for key in runs["on"]:
        assert runs["on"][key] == runs["off"][key], key
    names = {s.name for s in trace.spans()}
    # (one unipath at this size: no path_reads, localize or simplify)
    assert {"unipaths.count", "unipaths.condense", "unipaths.write",
            "ec.round", "fill.pairs", "dodgy.dup_pairs", "upload",
            "download", "artifact.save", "artifact.load"} <= names


def test_run_full_records_dag_waits_and_every_stage(tmp_path):
    rd = RunDir(str(tmp_path / "full"))
    prepare_sim_inputs(rd, *SIM, lambda *a: None)
    pipe = Pipeline(rd, AssemblyConfig.from_overrides(**CFG,
                                                      stage_workers=2),
                    lambda *a: None, device="cpu")
    with profiled():
        pipe.run_full()
    spans = trace.spans()
    stages = set(rd.manifest["stages"])
    assert {s.name for s in spans if s.name.startswith("stage.")} == {
        f"stage.{n}" for n in stages}
    waits = {s.attrs["stage"]: s for s in spans if s.name == "dag.wait"}
    assert set(waits) == stages - {"report"}    # report runs after the DAG
    assert all(0 <= w.t1 - w.t0 < 60 for w in waits.values())
    # a stage starts after the end of each of its dependencies
    by = {s.name[len("stage."):]: s for s in spans
          if s.name.startswith("stage.")}
    assert waits["polish"].t0 >= by["patch_gaps"].t1
    assert by["polish"].t0 >= waits["polish"].t1
    assert {s.run for s in spans} == {rd.path}
    assert len({s.thread for s in spans if s.name.startswith("stage.")}) > 1
    assert {"polish.realign", "polish.pileup"} <= {s.name for s in spans}


def test_profile_dir_trace_holds_spans_on_its_clock(tmp_path):
    """A known torch call's cpu_op events lie inside the span around it in
    the trace profile_dir writes."""
    pipe = Pipeline(RunDir(str(tmp_path / "run")), AssemblyConfig
                    .from_overrides(profile_dir=str(tmp_path / "trace")),
                    lambda *a: None, device="cpu")

    def fn():
        with trace.span("known.cumsum", n=4096):
            time.sleep(0.002)
            torch.cumsum(torch.ones(4096), 0)
            time.sleep(0.002)
        return {}

    pipe._profiled("known", fn)
    events = json.loads((tmp_path / "trace" / "known" / "trace.json")
                        .read_text())["traceEvents"]
    span_ev = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in span_ev] == ["known.cumsum"]
    sp = span_ev[0]
    assert sp["ph"] == "X" and sp["args"] == {"run": None, "n": 4096}
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"] == "aten::cumsum"]
    assert ops
    for e in ops:
        assert e["tid"] == sp["tid"] and e["pid"] == sp["pid"]
        assert sp["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= sp["ts"] + sp["dur"]
    assert sp["dur"] >= 4000
    # the two sleeps leave the op well inside: a clock off by more than a
    # millisecond would put it outside
    assert np.isclose(sp["ts"] + 2000, ops[0]["ts"], atol=1000)


def test_spans_stay_apart_under_threads():
    """Spans of many threads at once, with a short switch interval: none
    lost, each inner span's parent the outer span of its own thread."""
    import sys

    n_threads, n_each = 16, 300

    def work(i):
        for k in range(n_each):
            with trace.span("outer", i=i) as o:
                with trace.span("inner", i=i):
                    trace.add("k", k)
                o.add("k", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiled():
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = trace.spans()
    assert len(got) == 2 * n_threads * n_each
    inner = [s for s in got if s.name == "inner"]
    assert all(s.parent.name == "outer" and s.parent.thread == s.thread
               and s.parent.attrs == s.attrs for s in inner)
    assert sum(s.counters["k"] for s in inner) == n_threads * sum(
        range(n_each))
    assert all(s.counters == {"k": 1} for s in got if s.name == "outer")
