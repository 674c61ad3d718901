"""One tiny sample of each entry on the CPU through the harness's own
run (set-up, window, check), with the plain versions of the kernels, and
the faults of a run that the check has to catch. The cards' paths are
not reached here: `test_portbench_card.py` holds the one that needs a card.
"""

import argparse
import time

import numpy as np
import pytest

from portbench import harness

TINY = {"genome_size": 20_000, "repeat_families": [[1500, 2], [1000, 2]]}


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


def run_cpu(workload, trace=0):
    args = argparse.Namespace(workload=workload, seed=2**31 + 5,
                              seconds=0.1, trace=trace)
    return harness.run(args, time.perf_counter(), device="cpu")


EXACT = {"rsph.assemble": ("reads_bad", "spectrum_diff", "placements_bad"),
         "rsph.contigs": ("spectrum_diff",)}


@pytest.mark.parametrize("workload", sorted(EXACT))
def test_one_tiny_sample_of_each_entry(tiny, workload):
    res = run_cpu(workload, trace=1 if workload == "rsph.contigs" else 0)
    assert res["attempted"] == 1
    checks = res["checks"]
    for name in EXACT[workload]:
        assert checks[name]["value"] == 0, name
    assert checks["asm_err_ppm"]["value"] < 200_000
    if "unplaced_pct" in checks:
        assert checks["unplaced_pct"]["value"] < 25
    assert checks["genome_miss_pct"]["value"] < 10
    names = set(res["metrics"])
    if workload == "rsph.contigs":     # the traced run: per-layer metrics
        assert {"stage_s.validate", "stage_s.ec",
                "stage_s.unipaths"} <= names
        assert "device_idle_pct" not in names   # no card, no device trace
    else:
        assert names == {"genome_kb_per_s", "peak_device_gib", "setup_s"}


def test_control_fails_the_assembly_numbers(tiny):
    args = argparse.Namespace(workload="rsph.contigs", seed=9, seconds=0.1,
                              trace=0)
    res = harness.run(args, time.perf_counter(), device="cpu",
                      snp_rate=0.003)
    assert not res["correct"]
    for name in ("spectrum_diff", "asm_err_ppm", "genome_miss_pct"):
        c = res["checks"][name]
        assert c["value"] > c["limit"], name


def _zero_spectrum(monkeypatch):
    """validate_inputs' spectrum left as it starts: all zero."""
    import torch

    from allpathslg_tpu_torch.kmer import count

    monkeypatch.setattr(count, "spectrum_from_counts",
                        lambda c, max_freq=255: torch.zeros(
                            max_freq + 1, dtype=torch.int32))


def _half_batch(monkeypatch):
    """Every streamed count takes the first half of its reads only."""
    from allpathslg_tpu_torch.pipeline.stages import Pipeline

    count = Pipeline._count_streaming
    monkeypatch.setattr(Pipeline, "_count_streaming",
                        lambda self, codes, K, quals=None, **kw: count(
                            self, codes[:len(codes) // 2], K,
                            None if quals is None else quals[:len(codes) // 2],
                            **kw))


def _altered_placement(monkeypatch):
    """One placed read's stated mismatches off by one, where the aligner
    produces them."""
    from allpathslg_tpu_torch.align import lookup

    align = lookup.align_reads

    def altered(*a, **kw):
        c, d, o, mm, ok = align(*a, **kw)
        mm = mm.copy()
        mm[ok] += 1
        return c, d, o, mm, ok

    monkeypatch.setattr(lookup, "align_reads", altered)


def _half_unplaced(monkeypatch):
    """The aligner leaves the second half of every batch unplaced."""
    from allpathslg_tpu_torch.align import lookup

    align = lookup.align_reads

    def half(*a, **kw):
        c, d, o, mm, ok = align(*a, **kw)
        ok = ok.copy()
        ok[len(ok) // 2:] = False
        return c, d, o, mm, ok

    monkeypatch.setattr(lookup, "align_reads", half)


def _altered_read(monkeypatch):
    """A base of every imported fragment read altered by the FASTQ
    reader."""
    from allpathslg_tpu_torch.io import native_fastq

    read = native_fastq.read_fastq_arrays

    def altered(*a, **kw):
        out = read(*a, **kw)
        out[0][:, 7] = (out[0][:, 7] + 1) % 4
        return out

    monkeypatch.setattr(native_fastq, "read_fastq_arrays", altered)


FAULTS = [("rsph.contigs", _zero_spectrum, "spectrum_diff"),
          ("rsph.contigs", _half_batch, "spectrum_diff"),
          ("rsph.assemble", _altered_placement, "placements_bad"),
          ("rsph.assemble", _half_unplaced, "unplaced_pct"),
          ("rsph.assemble", _altered_read, "reads_bad")]


@pytest.mark.parametrize("workload,plant,number", FAULTS,
                         ids=[f[1].__name__.strip("_") for f in FAULTS])
def test_a_planted_fault_is_not_correct(tiny, monkeypatch, workload, plant,
                                        number):
    plant(monkeypatch)
    res = run_cpu(workload)
    assert not res["correct"] and res["failed"] == 1
    c = res["checks"][number]
    assert c["value"] > c["limit"]
