"""One tiny traced sample of rsph.assemble and of rsph.contigs on the CPU
through the harness's own run: every metric that reads the program's
spans reads a number in the cells its entry lists, and the per-layer
metrics that read the stages still do."""

import argparse
import time

import pytest

from portbench import harness

TINY = {"genome_size": 20_000, "repeat_families": [[1500, 2], [1000, 2]]}
SPAN_READERS = ("span_s.", "dag_wait_s")


@pytest.fixture
def tiny(monkeypatch):
    """harness.load_cell with the cell cut to a 20 kb genome, 4,096-read
    batches, one read set and a 12 kb warm-up."""
    load = harness.load_cell

    def small(workload, *a, **kw):
        bench, cell, cfg, traffic, limits = load(workload, *a, **kw)
        cfg = dict(cfg, **TINY, pipeline=dict(cfg["pipeline"],
                                              batch_reads=4096))
        traffic = dict(traffic, read_sets=1, warmup_genome_size=12_000)
        return bench, cell, cfg, traffic, limits

    monkeypatch.setattr(harness, "load_cell", small)


@pytest.mark.parametrize("workload", ["rsph.assemble", "rsph.contigs"])
def test_span_metrics_read_in_a_traced_sample(tiny, workload):
    from allpathslg_tpu_torch import trace

    bench = harness.load_cell(workload)[0]
    args = argparse.Namespace(workload=workload, seed=2**31 + 7,
                              seconds=0.1, trace=1)
    res = harness.run(args, time.perf_counter(), device="cpu")
    trace.clear()
    assert res["correct"] and res["attempted"] == 1
    listed = {m["name"] for m in harness.cell_metrics(bench, workload,
                                                      True)}
    spans = {n for n in listed if n.startswith(SPAN_READERS)}
    assert len(spans) == (8 if workload == "rsph.assemble" else 3)
    got = res["metrics"]
    for name in sorted(spans):
        assert got[name]["value"] > 0 and got[name]["unit"] == "s", name
    # the stage metrics stay; the device's need a card
    stages = {n for n in listed if n.startswith("stage_s.")}
    assert stages and stages <= set(got)
    assert set(got) == spans | stages
