"""One tiny sample of each entry on the CPU through the harness's own
run (set-up, window, check), with the plain versions of the kernels, and
the faults of a run that the check has to catch. The cards' paths are
not reached here: `test_portbench_card.py` holds the one that needs a card.
"""

import argparse
import hashlib
import time

import numpy as np
import pytest

from portbench import faults, harness

TINY = {"genome_size": 20_000, "repeat_families": [[1500, 2], [1000, 2]]}
# a configuration no BENCHMARK.json entry names, handed to the harness by
# the fixture: rsph_gage with a second haplotype and a long-jump library,
# assembled at ploidy 2, on a genome that holds the long insert
DIPLOID = "diploid_long_jump"
DIPLOID_CFG = {"genome_size": 60_000, "heterozygosity": 0.001,
               "long_jump": {"read_len": 76, "insert": 8_000, "sd": 800,
                             "coverage": 2.0}}
DIPLOID_LIMITS = {"long_jump_pairs_lost_pct": 50.0}


def shrink(monkeypatch):
    """harness.load_cell with the cell cut to a 20 kb genome, 4,096-read
    batches, one read set and a 12 kb warm-up; DIPLOID names rsph.assemble
    with DIPLOID_CFG, at ploidy 2."""
    load = harness.load_cell

    def small(workload, *a, **kw):
        diploid = workload == DIPLOID
        bench, cell, cfg, traffic, limits = load(
            "rsph.assemble" if diploid else workload, *a, **kw)
        pipeline = dict(cfg["pipeline"], batch_reads=4096)
        cfg = dict(cfg, **TINY, pipeline=pipeline)
        if diploid:
            cfg.update(DIPLOID_CFG, name=DIPLOID)
            pipeline["ploidy"] = 2
            limits = dict(limits, **DIPLOID_LIMITS)
        traffic = dict(traffic, read_sets=1, warmup_genome_size=12_000)
        return bench, cell, cfg, traffic, limits

    monkeypatch.setattr(harness, "load_cell", small)


@pytest.fixture
def tiny(monkeypatch):
    shrink(monkeypatch)


@pytest.fixture(scope="module")
def recorded():
    """One tiny run of a workload a module, shared by the tests that judge
    it: record(workload, trace) gives its result, the samples and read
    sets the check judged, and its limits."""
    runs = {}

    def record(workload, trace=0):
        if (workload, trace) not in runs:
            with pytest.MonkeyPatch.context() as mp:
                shrink(mp)
                got, check = {}, harness.check_samples

                def keep(samples, read_sets):
                    got.update(samples=samples, read_sets=read_sets)
                    return check(samples, read_sets)

                mp.setattr(harness, "check_samples", keep)
                got["res"] = run_cpu(workload, trace)
                got["limits"] = harness.load_cell(workload)[4]
            runs[workload, trace] = got
        return runs[workload, trace]

    return record


def run_cpu(workload, trace=0):
    args = argparse.Namespace(workload=workload, seed=2**31 + 5,
                              seconds=0.1, trace=trace)
    return harness.run(args, time.perf_counter(), device="cpu")


EXACT = {"rsph.assemble": ("reads_bad", "spectrum_diff", "placements_bad"),
         "rsph.contigs": ("spectrum_diff",)}


@pytest.mark.parametrize("workload", sorted(EXACT))
def test_one_tiny_sample_of_each_entry(recorded, workload):
    res = recorded(workload, 1 if workload == "rsph.contigs" else 0)["res"]
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


def _floor_40(monkeypatch):
    """jump_ec at the reference's floor of 40, which keeps no 2x37 pair."""
    from allpathslg_tpu_torch.pipeline.config import AssemblyConfig

    monkeypatch.setattr(harness, "assembly_config", lambda cfg: (
        AssemblyConfig.from_overrides(**dict(cfg["pipeline"],
                                             jump_min_prefix_len=40))))


FAULTS = [("rsph.contigs", _zero_spectrum, "spectrum_diff"),
          ("rsph.contigs", _half_batch, "spectrum_diff"),
          ("rsph.assemble", _altered_placement, "placements_bad"),
          ("rsph.assemble", _half_unplaced, "unplaced_pct"),
          ("rsph.assemble", _altered_read, "reads_bad"),
          ("saureus.assemble", _floor_40, "jump_pairs_lost_pct")]


@pytest.mark.parametrize("workload,plant,number", FAULTS,
                         ids=[f[1].__name__.strip("_") for f in FAULTS])
def test_a_planted_fault_is_not_correct(tiny, monkeypatch, workload, plant,
                                        number):
    plant(monkeypatch)
    res = run_cpu(workload)
    assert not res["correct"] and res["failed"] == 1
    c = res["checks"][number]
    assert c["value"] > c["limit"]


# faults planted in a sound run's jump libraries after it finished
JUMP_FAULTS = [("rsph.assemble", "shuffled_jump_mates"),
               ("rsph.assemble", "shifted_jump_anchors"),
               (DIPLOID, "long_jumps_dropped")]


@pytest.mark.parametrize("workload,fault", JUMP_FAULTS,
                         ids=[f for _, f in JUMP_FAULTS])
def test_a_planted_jump_fault_is_not_correct(recorded, workload, fault):
    r = recorded(workload)
    assert r["res"]["correct"], r["res"]["checks"]
    samples = faults.planted(r["samples"], r["read_sets"], fault)
    numbers = harness.check_samples(samples, r["read_sets"])
    correct, shown = harness.judge(harness.worst(numbers), r["limits"])
    assert not correct
    c = shown[f"{faults.JUMP_FAULTS[fault][0]}_pairs_lost_pct"]
    assert c["value"] > c["limit"]


def test_a_diploid_long_jump_configuration(recorded):
    """The harness takes a configuration with `long_jump` and
    `heterozygosity` as it is: long_jump_scaffolds runs, the long jumps
    are judged, and the assembly is judged against both haplotypes."""
    res = recorded(DIPLOID)["res"]
    checks = res["checks"]
    assert res["correct"], checks
    for name in ("reads_bad", "spectrum_diff", "placements_bad"):
        assert checks[name]["value"] == 0, name
    assert 0 < checks["long_jump_pairs_lost_pct"]["value"] < 50
    assert 0 < checks["jump_pairs_lost_pct"]["value"] < 50
    assert checks["asm_err_ppm"]["value"] < 6000


def test_long_reads_take_one_haplotype():
    _, _, cfg, _, _ = harness.load_cell("rsph.assemble")
    cfg = dict(cfg, heterozygosity=0.001,
               long={"coverage": 1, "mean_len": 2000, "min_len": 500,
                     "error_rate": 0.1})
    with pytest.raises(ValueError):
        harness.make_read_set(cfg, 1, 0, genome_size=20_000)


SEED = 2**31 + 5
# sha256 of make_read_set's arrays and write_read_set's files at the tiny
# size, read set 0 and the control's, as the commit before configurations
# could declare long jumps or a second haplotype gave them
READ_SET_DIGESTS = {
    "rsph.assemble":
        "06ab537bc6a5e03492bc8ce50ac576812b59a505288081e5cb905e461596dceb",
    "rsph.contigs":
        "5bdab53f6f669b5fb28fd0f67ea08311ea1329aa901831997c7fecb4f87aca15",
    "saureus.assemble":
        "d7f562e892a161a8b44dcf5cda124ae69156ef263d3054a7f5f9003950da2844",
}


def read_set_digest(workload: str, d) -> str:
    from allpathslg_tpu_torch.pipeline.rundir import RunDir

    _, _, cfg, traffic, _ = harness.load_cell(workload)
    h = hashlib.sha256()

    def arrays(named):
        for key in sorted(named):
            a = np.ascontiguousarray(named[key])
            h.update(f"{key} {a.dtype.str} {a.shape}".encode())
            h.update(a.tobytes())

    for snp_rate in (0.0, 0.003):
        rs = harness.make_read_set(cfg, SEED, 0, snp_rate=snp_rate)
        arrays({"genome": rs["genome"]})
        for lib in ("frag", "jump", "long_jump", "long"):
            if lib in rs:
                h.update(lib.encode())
                arrays(rs[lib])
        harness.write_read_set(cfg, traffic, rs, d)
        for f in sorted((d / "files").glob("*")):
            h.update(f.name.encode())
            h.update(f.read_bytes())
        rd = RunDir(str(d / "artifacts"))
        for art in ("frag_reads_orig", "jump_reads_orig",
                    "long_jump_reads_orig", "long_reads_orig",
                    "genome_truth"):
            if rd.has(art):
                h.update(art.encode())
                arrays(dict(rd.load_arrays(art)))
    return h.hexdigest()


@pytest.mark.parametrize("workload", ["rsph.assemble", "rsph.contigs",
                                      "saureus.assemble"])
def test_read_sets_are_byte_identical(tiny, tmp_path, workload):
    """A configuration without `long_jump` or `heterozygosity` draws and
    writes what it drew and wrote before they existed."""
    assert read_set_digest(workload, tmp_path) == READ_SET_DIGESTS[workload]
