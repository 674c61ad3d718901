"""The port's run_full with long jumps, PacBio and an assisting reference ==
the reference's, byte for byte.

Both packages run `run_full` on chip_smoke.py phase 9b's inputs: the
reference's tests/test_repeat_longread_e2e.py genome (60 kb, a 2.5 kb
exact repeat at 10,000 and 40,000) with 50x fragment reads, 15x jump reads
of 4000 +- 350 and 12x PacBio reads, plus a 6x long-jump library of
12000 +- 1200 and `assist_ref`, a FASTA of a 0.3 %-SNP relative
(batch_reads=16384). long_jump_scaffolds, long_read_patch and assisted run
between make_scaffolds and polish. Every artifact, text file and stage
metric must be identical. long_read_patch's medoid DP runs at a band above
15: on a card, the general kernel's route, recorded at the port's
dispatcher.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import chip_smoke as cs  # noqa: E402
from allpathslg_tpu.pipeline.rundir import RunDir as RRunDir  # noqa: E402
from allpathslg_tpu_torch.ops import banded as tbanded  # noqa: E402
from allpathslg_tpu_torch import trace  # noqa: E402
from allpathslg_tpu_torch.pipeline.config import AssemblyConfig as TConfig  # noqa: E402
from allpathslg_tpu_torch.pipeline.rundir import RunDir as TRunDir  # noqa: E402
from allpathslg_tpu_torch.pipeline.stages import Pipeline as TPipeline  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TEXT_FILES = list(cs.CMP_TEXT_FILES)


def _quiet(*a):
    pass


def _start_reference(path, overrides):
    """The reference's run_full on run dir `path` in a child process, so
    that it runs beside the port's."""
    code = ("import json, sys\n"
            "from allpathslg_tpu.pipeline.config import AssemblyConfig\n"
            "from allpathslg_tpu.pipeline.rundir import RunDir\n"
            "from allpathslg_tpu.pipeline.stages import Pipeline\n"
            "cfg = AssemblyConfig.from_overrides(**json.loads(sys.argv[2]))\n"
            "Pipeline(RunDir(sys.argv[1]), cfg, lambda *a: None).run_full()\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    err = open(os.path.join(path, "reference.stderr"), "w")
    proc = subprocess.Popen([sys.executable, "-c", code, str(path),
                             json.dumps(overrides)], cwd=str(ROOT), env=env,
                            stdout=subprocess.DEVNULL, stderr=err)
    err.close()
    return proc


def _finish_reference(proc):
    proc.wait(timeout=1200)
    with open(os.path.join(proc.args[3], "reference.stderr")) as f:
        assert proc.returncode == 0, f.read()[-4000:]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    inputs, g = cs.long_cmp_inputs()
    ref_fa = tmp_path_factory.mktemp("assist") / "relative.fasta"
    cs.write_assist_ref(ref_fa, g)
    cfg = dict(batch_reads=16384, assist_ref=str(ref_fa))
    rd_r = RRunDir(str(tmp_path_factory.mktemp("ref")))
    rd_t = TRunDir(str(tmp_path_factory.mktemp("port")))
    cs.save_inputs(rd_r, inputs)
    cs.save_inputs(rd_t, inputs)
    ref = _start_reference(rd_r.path, cfg)
    calls = []
    orig = tbanded.banded_align_auto

    def logged(q, q_len, t, t_len, offset, band=16, **kw):
        calls.append((trace.current_stage(), band, tuple(q.shape),
                      tuple(t.shape)))
        return orig(q, q_len, t, t_len, offset, band=band, **kw)

    tbanded.banded_align_auto = logged
    try:
        TPipeline(rd_t, TConfig.from_overrides(**cfg), _quiet,
                  device="cpu").run_full()
    finally:
        tbanded.banded_align_auto = orig
        _finish_reference(ref)
    return RRunDir(rd_r.path), rd_t, calls


@pytest.mark.parametrize("art", cs.LONG_ARTIFACTS)
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


@pytest.mark.parametrize("stage", cs.LONG_STAGES)
def test_stage_metrics_equal(both, stage):
    rd_r, rd_t, _ = both
    m = rd_t.metrics(stage)
    assert m and "skipped" not in m and rd_r.metrics(stage) == m


def test_long_read_patch_took_the_general_route(both):
    """The medoid's all-pairs DP runs at band max(16, 0.25 x median) <=
    192, above the bit-parallel kernel's 15, on n x n pairs padded to a
    multiple of 128 rows; the consensus refinement's batches (band 6) are
    padded to a multiple of 256; at least one gap closes."""
    _, rd_t, calls = both
    lr = [c for c in calls if c[0] == "long_read_patch"]
    wide = [c for c in lr if c[1] > 15]
    assert wide, lr
    assert all(16 <= band <= 192 and q[0] % 128 == 0
               for _, band, q, _ in wide)
    assert all(q[0] % 256 == 0 for _, band, q, _ in lr if band <= 15)
    assert rd_t.metrics("long_read_patch")["n_gaps_closed"] >= 1


def test_assisted_took_band_16(both):
    """assisted's junction refinement: B = 1 at band 16."""
    _, rd_t, calls = both
    asg = [c for c in calls if c[0] == "assisted"]
    m = rd_t.metrics("assisted")
    assert m["n_contigs_placed"] >= 1
    if m["n_patches_closed"] + m["n_patches_rejected"]:
        assert asg and all(band == 16 and q[0] == 1 for _, band, q, _ in asg)


def test_long_jumps_did_work(both):
    """The long-jump pass aligns its pairs and keeps the scaffold N50."""
    _, rd_t, _ = both
    lj = rd_t.metrics("long_jump_scaffolds")
    assert lj["n_aligned"] > 0
    assert lj["scaffold_n50"] >= rd_t.metrics("make_scaffolds")["scaffold_n50"]
    assert lj["n_scaffolds_out"] <= lj["n_scaffolds_in"]
    assert rd_t.metrics("evaluate")["genome_covered_frac"] > 0.85
