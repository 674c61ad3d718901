"""The port's run_full with a jump library == the reference's, byte for byte.

Both packages run `run_full` (jump_ec -> align_jumps -> make_scaffolds ->
patch_gaps -> polish -> clean_final -> finalize / submission_prep /
evaluate -> report, after the contig slice) on the same inputs: a 40 kb
genome carrying a two-copy 2.5 kb exact repeat, 40x fragment reads and 15x
jump reads of 4000 +- 350 (batch_reads=4096). The repeat breaks the
contigs, the jump pairs scaffold across it with a negative gap, and
patch_gaps aligns that junction at a band above 15: the general banded
DP's route, which the test records at the port's dispatcher. Every
artifact (arrays, superb/AGP, FASTA/EFASTA, the submission package and the
report text) and every stage metric must be identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from allpathslg_tpu.pipeline.config import AssemblyConfig as RConfig  # noqa: E402
from allpathslg_tpu.pipeline.rundir import RunDir as RRunDir  # noqa: E402
from allpathslg_tpu.pipeline.stages import Pipeline as RPipeline  # noqa: E402
from allpathslg_tpu_torch.eval import sim  # noqa: E402
from allpathslg_tpu_torch.ops import banded as tbanded  # noqa: E402
from allpathslg_tpu_torch.pipeline.config import AssemblyConfig as TConfig  # noqa: E402
from allpathslg_tpu_torch.pipeline.rundir import RunDir as TRunDir  # noqa: E402
from allpathslg_tpu_torch.pipeline.stages import Pipeline as TPipeline  # noqa: E402

torch.set_num_threads(2)
GENOME, REPEAT, LOCI = 40_000, 2_500, (10_000, 25_000)
CFG = dict(batch_reads=4096)
STAGES = ["validate_inputs", "remove_dodgy", "precorrect", "find_errors",
          "clean_reads", "fill_fragments", "unipaths", "jump_ec",
          "align_jumps", "make_scaffolds", "align_frags", "patch_gaps",
          "polish", "clean_final", "finalize", "submission_prep", "evaluate",
          "report"]
ARTIFACTS = ["kspec_25mer", "jump_reads_ec", "jump_alignlets",
             "jump_distribs", "frag_alignlets", "unibases", "contigs_final"]
TEXT_FILES = ["assembly.superb", "assembly.agp", "final.assembly.fasta",
              "final.assembly.efasta", "submission/contigs.fsa",
              "submission/assembly.agp", "submission/scaffolds.fsa",
              "assembly.report"]


def _quiet(*a):
    pass


def repeat_inputs():
    """Input arrays: the genome with one exact repeat at two loci, a
    fragment and a jump library (the reference's simulator seeds)."""
    g = sim.random_genome(GENOME, seed=71)
    a, b = LOCI
    g[b:b + REPEAT] = g[a:a + REPEAT]
    batch, pairs, _ = sim.simulate_paired_reads(g, coverage=40,
                                                error_rate=0.005, seed=1)
    jb, jp, _ = sim.simulate_paired_reads(
        g, coverage=15, error_rate=0.005, insert_mean=4000, insert_sd=350,
        outward=True, seed=2)
    return {
        "frag_reads_orig": dict(codes=batch.codes, lengths=batch.lengths,
                                quals=batch.quals, pairs=pairs.pairs),
        "jump_reads_orig": dict(codes=jb.codes, lengths=jb.lengths,
                                quals=jb.quals, pairs=jp.pairs,
                                lib_sep=np.array([4000], np.int32),
                                lib_sd=np.array([350], np.int32)),
        "genome_truth": dict(genome=g),
    }


def _save(rd, inputs):
    for art, arrays in inputs.items():
        rd.save_arrays(art, **{k: np.asarray(v) for k, v in arrays.items()})


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    inputs = repeat_inputs()
    rd_r = RRunDir(str(tmp_path_factory.mktemp("ref")))
    rd_t = TRunDir(str(tmp_path_factory.mktemp("port")))
    _save(rd_r, inputs)
    _save(rd_t, inputs)
    RPipeline(rd_r, RConfig.from_overrides(**CFG), _quiet).run_full()
    calls = []
    orig = tbanded.banded_align_auto

    def logged(q, q_len, t, t_len, offset, band=16, **kw):
        calls.append((band, tuple(q.shape), tuple(t.shape)))
        return orig(q, q_len, t, t_len, offset, band=band, **kw)

    tbanded.banded_align_auto = logged
    try:
        port = TPipeline(rd_t, TConfig.from_overrides(**CFG), _quiet,
                         device="cpu")
        port.run_full()
    finally:
        tbanded.banded_align_auto = orig
    return rd_r, rd_t, calls


@pytest.mark.parametrize("art", ARTIFACTS)
def test_artifacts_byte_identical(both, art):
    rd_r, rd_t, _ = both
    a, b = rd_r.load_arrays(art), rd_t.load_arrays(art)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), (art, k)


@pytest.mark.parametrize("name", TEXT_FILES + ["circular_tags.npy"])
def test_files_byte_identical(both, name):
    rd_r, rd_t, _ = both
    with open(rd_r.file_path(name), "rb") as f:
        a = f.read()
    with open(rd_t.file_path(name), "rb") as f:
        b = f.read()
    assert a and a == b


@pytest.mark.parametrize("stage", STAGES)
def test_stage_metrics_equal(both, stage):
    rd_r, rd_t, _ = both
    assert rd_t.metrics(stage) and rd_r.metrics(stage) == rd_t.metrics(stage)


def test_patch_gaps_took_the_general_route(both):
    """The negative junction at the repeat is aligned at a band above the
    bit-parallel kernel's 15: on a card, the general kernel."""
    _, rd_t, calls = both
    wide = [c for c in calls if c[0] > 15]
    assert wide, calls
    assert all(band in (24, 48, 96, 192) for band, _, _ in wide)
    assert rd_t.metrics("patch_gaps")["n_gaps_closed"] >= 1


def test_full_run_did_work(both):
    """Jump pairs place with the simulated insert, scaffolds join the
    contigs, and the final assembly covers the genome."""
    _, rd_t, _ = both
    aj = rd_t.metrics("align_jumps")
    assert aj["align_rate"] > 0.9
    assert abs(aj["insert_mean_est"] - 4000) < 0.1 * 4000
    sc = rd_t.metrics("make_scaffolds")
    un = rd_t.metrics("unipaths")
    assert 1 <= sc["n_scaffolds"] < un["n_contigs"]
    ev = rd_t.metrics("evaluate")
    assert ev["genome_covered_frac"] > 0.85
    assert ev["misassembly_breaks"] == 0
    with open(rd_t.file_path("final.assembly.fasta")) as f:
        n_final = f.read().count(">")
    # clean_final drops scaffolds of short contigs only
    assert 1 <= n_final <= sc["n_scaffolds"]
    assert rd_t.metrics("finalize")["n_records"] == n_final


def test_prepare_sim_inputs_with_jump_libraries(tmp_path):
    """The CLI's simulated inputs with two jump libraries: the reference's
    artifacts, byte for byte."""
    from allpathslg_tpu.pipeline.run import prepare_sim_inputs as rprepare
    from allpathslg_tpu_torch.pipeline.run import prepare_sim_inputs as tprep

    libs = [(3000, 300, 4.0), (6000, 600, 2.0)]
    rd_r = RRunDir(str(tmp_path / "ref"))
    rd_t = TRunDir(str(tmp_path / "port"))
    rprepare(rd_r, 12_000, 5.0, 0.005, 100, 3, _quiet, jump_libs=libs)
    tprep(rd_t, 12_000, 5.0, 0.005, 100, 3, _quiet, jump_libs=libs)
    for art in ("frag_reads_orig", "jump_reads_orig", "genome_truth"):
        a, b = rd_r.load_arrays(art), rd_t.load_arrays(art)
        assert sorted(a) == sorted(b)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a), art


def test_prepare_sim_inputs_with_long_jumps_and_pacbio(tmp_path):
    """The CLI's simulated inputs with a long-jump library and PacBio
    reads: the reference's artifacts, byte for byte."""
    from allpathslg_tpu.pipeline.run import prepare_sim_inputs as rprepare
    from allpathslg_tpu_torch.pipeline.run import prepare_sim_inputs as tprep

    kw = dict(jump_coverage=3.0, pacbio_coverage=4.0,
              long_jump_libs=[(10000, 1000, 2.0), (8000, 800, 1.0)])
    rd_r = RRunDir(str(tmp_path / "ref"))
    rd_t = TRunDir(str(tmp_path / "port"))
    rprepare(rd_r, 24_000, 5.0, 0.005, 100, 3, _quiet, **kw)
    tprep(rd_t, 24_000, 5.0, 0.005, 100, 3, _quiet, **kw)
    for art in ("frag_reads_orig", "jump_reads_orig", "long_jump_reads_orig",
                "long_reads_orig", "genome_truth"):
        a, b = rd_r.load_arrays(art), rd_t.load_arrays(art)
        assert sorted(a) == sorted(b)
        assert all(a[k].dtype == b[k].dtype and a[k].tobytes() ==
                   b[k].tobytes() for k in a), art


def test_cli_long_jumps_and_pacbio(tmp_path):
    """`--long-jump-libs 10000:1000:2 --pacbio-coverage 4`: the CLI
    prepares the long-jump and PacBio artifacts as the reference's
    prepare_sim_inputs does, then starts run_full (stopped here by the
    fault-injection hook at its first stage)."""
    from allpathslg_tpu.pipeline.run import prepare_sim_inputs as rprepare
    from allpathslg_tpu_torch.pipeline import run

    with pytest.raises(RuntimeError, match="injected fault"):
        run.main(["--run-dir", str(tmp_path / "port"), "--sim-genome",
                  "24000", "--coverage", "5", "--device", "cpu",
                  "--long-jump-libs", "10000:1000:2", "--pacbio-coverage",
                  "4", "fault_stage=validate_inputs"])
    rd_r = RRunDir(str(tmp_path / "ref"))
    rprepare(rd_r, 24_000, 5.0, 0.005, 100, 0, _quiet, pacbio_coverage=4.0,
             long_jump_libs=[(10000, 1000, 2.0)])
    rd_t = TRunDir(str(tmp_path / "port"))
    for art in ("long_jump_reads_orig", "long_reads_orig"):
        a, b = rd_r.load_arrays(art), rd_t.load_arrays(art)
        assert sorted(a) == sorted(b)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a), art
    assert not rd_t.has("jump_reads_orig")


def test_launch_counts_by_stage_under_threads():
    """Kernel launch counts stay exact and apart per stage when stages run
    in threads at once, as run_full's DAG runs them."""
    import sys
    import threading

    from allpathslg_tpu_torch.ops.cuda import launches

    n_threads, n_each = 16, 2000

    def work(i):
        with launches.stage(f"stage{i % 4}"):
            for _ in range(n_each):
                launches.record("k_test")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        launches.reset("k_test")
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert launches.count("k_test") == n_threads * n_each
    per = launches.by_stage()
    for s in range(4):
        assert per[f"stage{s}"]["k_test"] == n_threads // 4 * n_each
    assert "k_test" not in per.get(None, {})
    launches.reset("k_test")
    assert launches.count("k_test") == 0
