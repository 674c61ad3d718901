"""The port's run_full on an 8-shard mesh == the reference's on its
8-device mesh, byte for byte.

Both packages run `run_full` with n_devices=8 on tests/test_pipeline_mesh.py's
inputs (20 kb x 40x fragment reads, 20x jump reads of 2000 +- 200, seed
11, batch_reads 4096, stage_workers 1): the counting stages route through
hash-sharded all_to_all counting (parallel/dist_count), the K=96 table
through the distributed sample sort and the unipath chain sums through the
ring scan. The port's mesh is on the CPU; the reference's on the
conftest's virtual CPU devices, in a child process beside the port.
kspec_25mer, frag_reads_edit, frag_reads_corr, unibases, strong_table.npy,
the assembly report and every stage metric must be identical. Also: the
mesh find_errors counts from the resident batches, so its only read-set
download is the artifact save.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from allpathslg_tpu.pipeline.rundir import RunDir as RRunDir  # noqa: E402
from allpathslg_tpu_torch.pipeline.config import AssemblyConfig as TConfig  # noqa: E402
from allpathslg_tpu_torch.pipeline.rundir import RunDir as TRunDir  # noqa: E402
from allpathslg_tpu_torch.pipeline.run import prepare_sim_inputs as tprepare  # noqa: E402
from allpathslg_tpu_torch.pipeline.stages import Pipeline as TPipeline  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SIM = (20000, 40.0, 0.005, 100, 11)
JUMPS = dict(jump_coverage=20.0, jump_insert=2000, jump_sd=200)
CFG = dict(batch_reads=4096, n_devices=8, stage_workers=1)
ARTIFACTS = ("kspec_25mer", "frag_reads_edit", "frag_reads_corr", "unibases")


def _quiet(*a):
    pass


def _start_reference(path):
    """The reference's prepare_sim_inputs + run_full on 8 virtual CPU
    devices, in a child process."""
    code = ("import json, sys\n"
            "from allpathslg_tpu.pipeline.config import AssemblyConfig\n"
            "from allpathslg_tpu.pipeline.rundir import RunDir\n"
            "from allpathslg_tpu.pipeline.run import prepare_sim_inputs\n"
            "from allpathslg_tpu.pipeline.stages import Pipeline\n"
            "a = json.loads(sys.argv[2])\n"
            "rd = RunDir(sys.argv[1])\n"
            "prepare_sim_inputs(rd, *a['sim'], lambda *x: None, **a['jumps'])\n"
            "cfg = AssemblyConfig.from_overrides(**a['cfg'])\n"
            "rep = Pipeline(rd, cfg, lambda *x: None).run_full()\n"
            "open(sys.argv[1] + '/report.json', 'w').write(json.dumps(rep))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    err = open(os.path.join(path, "reference.stderr"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(path),
         json.dumps(dict(sim=SIM, jumps=JUMPS, cfg=CFG))],
        cwd=str(ROOT), env=env, stdout=subprocess.DEVNULL, stderr=err)
    err.close()
    return proc


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's run, started before the file's first test so that
    the port's work runs beside it."""
    path = tmp_path_factory.mktemp("ref8")
    proc = _start_reference(path)
    yield path, proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def both(reference, tmp_path_factory):
    """(reference run dir, its report, the port's 8-shard run dir, its
    report, its log, the port's 1-device strong table)."""
    path_r, ref = reference
    rd_t = TRunDir(str(tmp_path_factory.mktemp("port8")))
    tprepare(rd_t, *SIM, _quiet, **JUMPS)
    logged = []
    pipe = TPipeline(rd_t, TConfig.from_overrides(**CFG), logged.append,
                     device="cpu")
    rep_t = pipe.run_full()
    rd_1 = TRunDir(str(tmp_path_factory.mktemp("port1")))
    tprepare(rd_1, *SIM, _quiet, **JUMPS)
    one = TPipeline(rd_1, TConfig.from_overrides(**dict(CFG, n_devices=1)),
                    _quiet, device="cpu")
    for s in ("remove_dodgy", "precorrect", "find_errors"):
        getattr(one, s)()
    table_1 = np.load(rd_1.file_path("strong_table.npy"))
    ref.wait(timeout=1200)
    with open(path_r / "reference.stderr") as f:
        assert ref.returncode == 0, f.read()[-4000:]
    with open(path_r / "report.json") as f:
        rep_r = json.load(f)
    return RRunDir(str(path_r)), rep_r, rd_t, rep_t, logged, table_1


def test_mesh_ec_zero_read_roundtrips(tmp_path):
    """The mesh find_errors counts from the RESIDENT packed batches: the
    only read-set download is the final artifact save, however many EC
    rounds ran. (First in the file: it runs beside the reference's run.)"""
    rd = TRunDir(str(tmp_path / "meshec"))
    tprepare(rd, 20000, 40.0, 0.01, 100, 5, _quiet)
    cfg = TConfig.from_overrides(batch_reads=4096, n_devices=8,
                                 stage_workers=1, round_checkpoints=False)
    pipe = TPipeline(rd, cfg, _quiet, device="cpu")
    pipe.remove_dodgy()
    pipe.precorrect()
    db = pipe._read_cache["frag_reads_prec"]
    before = db.n_host_downloads
    m = pipe.find_errors()
    assert m["n_corrections"] > 0
    assert db.n_host_downloads - before == 1


def test_mesh_logged(both):
    logged = both[4]
    assert "[pipeline] mesh: 8 devices (cpu)" in logged


@pytest.mark.parametrize("art", ARTIFACTS)
def test_mesh_artifacts_byte_identical(both, art):
    rd_r, _, rd_t = both[:3]
    a, b = rd_r.load_arrays(art), rd_t.load_arrays(art)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), (art, k)


@pytest.mark.parametrize("name", ["strong_table.npy", "assembly.report",
                                  "unibases.fasta"])
def test_mesh_files_byte_identical(both, name):
    rd_r, _, rd_t = both[:3]
    with open(rd_r.file_path(name), "rb") as f:
        a = f.read()
    with open(rd_t.file_path(name), "rb") as f:
        b = f.read()
    assert a and a == b


def test_mesh_report_and_metrics_identical(both):
    rd_r, rep_r, rd_t, rep_t = both[:4]
    assert json.loads(json.dumps(rep_t)) == rep_r
    stages = rd_r.manifest["stages"]
    assert set(stages) == set(rd_t.manifest["stages"])
    for s in stages:
        assert rd_r.metrics(s) == rd_t.metrics(s), s


def test_mesh_equals_one_device_strong_table(both):
    """find_errors' strong table on the port's mesh == on one device."""
    _, _, rd_t, _, _, table_1 = both
    assert table_1.tobytes() == \
        np.load(rd_t.file_path("strong_table.npy")).tobytes()
