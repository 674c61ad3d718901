"""The port's run_full on a diploid genome with two jump libraries, long
jumps and PacBio == the reference's, byte for byte.

A 60 kb copy of chip_smoke.py phase 10's configuration (the reference's
tests/test_scale_diploid_multilib.py): ploidy=2, haplotype 2 with 0.1 %
SNPs, 30x fragment reads of each haplotype, jump libraries of 3000 +- 300
(12x, haplotype 1) and 6000 +- 600 (10x, haplotype 2), a 12000 +- 1200
long-jump library (6x) and 5x PacBio; haplotype 1 is phase 9b's 60 kb
genome with its 2.5 kb repeat, so the long reads find gaps. No
`assist_ref`: the reference's assisted stage saves contigs_final without
its ambiguity arrays (ROADMAP.md Queue 3). Per-library insert statistics,
the ambiguity arrays carried through patch_gaps / long_read_patch /
polish / clean_final and the final EFASTA's {a,b} records must be
identical.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import chip_smoke as cs  # noqa: E402
from test_torch_full_long import _finish_reference, _start_reference  # noqa: E402
from allpathslg_tpu.pipeline.rundir import RunDir as RRunDir  # noqa: E402
from allpathslg_tpu_torch.pipeline.config import AssemblyConfig as TConfig  # noqa: E402
from allpathslg_tpu_torch.pipeline.rundir import RunDir as TRunDir  # noqa: E402
from allpathslg_tpu_torch.pipeline.stages import Pipeline as TPipeline  # noqa: E402

torch.set_num_threads(2)
CFG = dict(batch_reads=16384, ploidy=2)
STAGES = [s for s in cs.LONG_STAGES if s != "assisted"]


def _quiet(*a):
    pass


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    inputs = cs.diploid_inputs(cs.repeat_60kb())
    rd_r = RRunDir(str(tmp_path_factory.mktemp("ref")))
    rd_t = TRunDir(str(tmp_path_factory.mktemp("port")))
    cs.save_inputs(rd_r, inputs)
    cs.save_inputs(rd_t, inputs)
    ref = _start_reference(rd_r.path, CFG)
    try:
        TPipeline(rd_t, TConfig.from_overrides(**CFG), _quiet,
                  device="cpu").run_full()
    finally:
        _finish_reference(ref)
    return RRunDir(rd_r.path), rd_t


@pytest.mark.parametrize("art", ["jump_distribs", "jump_alignlets",
                                 "long_jump_alignlets", "unibases",
                                 "contigs_final"])
def test_artifacts_byte_identical(both, art):
    rd_r, rd_t = both
    a, b = rd_r.load_arrays(art), rd_t.load_arrays(art)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), (art, k)


def test_ambiguity_arrays_survive_and_match(both):
    """contigs_final carries the diploid records through the long-read
    merges, and they are the reference's."""
    rd_r, rd_t = both
    a, b = rd_r.load_arrays("contigs_final"), rd_t.load_arrays("contigs_final")
    amb = [k for k in a if k.startswith("amb")]
    assert amb and sorted(amb) == sorted(k for k in b if k.startswith("amb"))
    for k in amb:
        assert a[k].tobytes() == b[k].tobytes(), k
    assert rd_t.metrics("long_read_patch")["n_ambiguities_kept"] > 0


@pytest.mark.parametrize("name", ["final.assembly.efasta",
                                  "final.assembly.fasta", "assembly.superb",
                                  "assembly.report"])
def test_files_byte_identical(both, name):
    rd_r, rd_t = both
    with open(rd_r.file_path(name), "rb") as f:
        a = f.read()
    with open(rd_t.file_path(name), "rb") as f:
        b = f.read()
    assert a and a == b


def test_efasta_holds_ambiguity_records(both):
    _, rd_t = both
    with open(rd_t.file_path("final.assembly.efasta")) as f:
        text = f.read()
    assert text.count("{") >= 1 and "," in text
    assert rd_t.metrics("finalize").get("n_ambiguities", 0) >= 1


@pytest.mark.parametrize("stage", STAGES)
def test_stage_metrics_equal(both, stage):
    rd_r, rd_t = both
    m = rd_t.metrics(stage)
    assert m and "skipped" not in m and rd_r.metrics(stage) == m


def test_two_libraries_estimated_apart(both):
    """align_jumps estimates each library's insert on its own."""
    _, rd_t = both
    aj = rd_t.metrics("align_jumps")
    means = aj["lib_insert_means"]
    assert len(means) == 2
    assert abs(means[0] - 3000) < 300 and abs(means[1] - 6000) < 600
