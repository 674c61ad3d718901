"""The port imports torch and never jax; the reference never imports torch;
chip_smoke.py refuses to run without a CUDA device; the port's functions
that take a device default to the card."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

PORT_MODULES = [
    "allpathslg_tpu_torch",
    "allpathslg_tpu_torch.align.lookup",
    "allpathslg_tpu_torch.align.mxu_scan",
    "allpathslg_tpu_torch.align.packalign",
    "allpathslg_tpu_torch.asm.amb",
    "allpathslg_tpu_torch.asm.assisted",
    "allpathslg_tpu_torch.asm.clean_assembly",
    "allpathslg_tpu_torch.asm.fill",
    "allpathslg_tpu_torch.asm.localize",
    "allpathslg_tpu_torch.asm.longread",
    "allpathslg_tpu_torch.asm.patch",
    "allpathslg_tpu_torch.asm.polish",
    "allpathslg_tpu_torch.convert",
    "allpathslg_tpu_torch.dtypes.devcache",
    "allpathslg_tpu_torch.dtypes.packed",
    "allpathslg_tpu_torch.dtypes.reads",
    "allpathslg_tpu_torch.ec.jump",
    "allpathslg_tpu_torch.ec.precorrect",
    "allpathslg_tpu_torch.ec.spectrum_ec",
    "allpathslg_tpu_torch.eval.accuracy",
    "allpathslg_tpu_torch.eval.oracle",
    "allpathslg_tpu_torch.eval.sim",
    "allpathslg_tpu_torch.eval.stats",
    "allpathslg_tpu_torch.graph.cleanup",
    "allpathslg_tpu_torch.graph.coverage",
    "allpathslg_tpu_torch.graph.digraph",
    "allpathslg_tpu_torch.graph.pathsdb",
    "allpathslg_tpu_torch.graph.ulinks",
    "allpathslg_tpu_torch.graph.unipath",
    "allpathslg_tpu_torch.io.efasta",
    "allpathslg_tpu_torch.io.fasta",
    "allpathslg_tpu_torch.io.native_fastq",
    "allpathslg_tpu_torch.io.sam",
    "allpathslg_tpu_torch.kmer.bits",
    "allpathslg_tpu_torch.kmer.count",
    "allpathslg_tpu_torch.kmer.kmerize",
    "allpathslg_tpu_torch.kmer.spectrum",
    "allpathslg_tpu_torch.long.consensus",
    "allpathslg_tpu_torch.long.eval_by_reads",
    "allpathslg_tpu_torch.long.friends",
    "allpathslg_tpu_torch.long.longproto",
    "allpathslg_tpu_torch.long.supported",
    "allpathslg_tpu_torch.long.ultra",
    "allpathslg_tpu_torch.models.flagship",
    "allpathslg_tpu_torch.native.build",
    "allpathslg_tpu_torch.ops.affine",
    "allpathslg_tpu_torch.ops.banded",
    "allpathslg_tpu_torch.ops.bucket_count",
    "allpathslg_tpu_torch.ops.cuda.banded_cuda",
    "allpathslg_tpu_torch.ops.cuda.banded_general_cuda",
    "allpathslg_tpu_torch.ops.cuda.nvcc",
    "allpathslg_tpu_torch.ops.cuda.row_sort_cuda",
    "allpathslg_tpu_torch.ops.cuda.sort_cuda",
    "allpathslg_tpu_torch.ops.join",
    "allpathslg_tpu_torch.ops.segmented",
    "allpathslg_tpu_torch.ops.sort",
    "allpathslg_tpu_torch.parallel.dist_count",
    "allpathslg_tpu_torch.parallel.mesh",
    "allpathslg_tpu_torch.parallel.multihost",
    "allpathslg_tpu_torch.parallel.ring",
    "allpathslg_tpu_torch.parallel.sample_sort",
    "allpathslg_tpu_torch.pipeline.config",
    "allpathslg_tpu_torch.pipeline.prepare",
    "allpathslg_tpu_torch.pipeline.run",
    "allpathslg_tpu_torch.pipeline.rundir",
    "allpathslg_tpu_torch.pipeline.stages",
    "allpathslg_tpu_torch.scaffold.circular",
    "allpathslg_tpu_torch.scaffold.links",
    "allpathslg_tpu_torch.scaffold.longjump",
    "allpathslg_tpu_torch.scaffold.scaffolder",
    "allpathslg_tpu_torch.scaffold.superb",
    "allpathslg_tpu_torch.tools",
    "allpathslg_tpu_torch.trace",
    "allpathslg_tpu_torch.tune_count",
    "allpathslg_tpu_torch.tuning",
    "allpathslg_tpu_torch.utils.intdist",
]

REFERENCE_MODULES = [m.replace("allpathslg_tpu_torch", "allpathslg_tpu")
                     for m in PORT_MODULES
                     if m.split(".")[-1] not in (
                         "convert", "sort_cuda", "banded_cuda",
                         "banded_general_cuda", "trace", "nvcc",
                         "row_sort_cuda", "tune_count")] + [
    "allpathslg_tpu.ops.pallas.sort_pallas",
    "allpathslg_tpu.ops.pallas.banded_bp",
    "allpathslg_tpu.ops.pallas.banded_pallas",
]


def _run(code: str, cwd=ROOT, timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_with_jax_blocked():
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'allpathslg_tpu'\n"
            "       or m.startswith('allpathslg_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_reference_imports_with_torch_blocked():
    code = ("import sys, importlib\n"
            "sys.modules['torch'] = None\n"
            f"for m in {REFERENCE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    r = _run(code, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_cuda_or_package(tmp_path, alone):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke would run for real")
    cwd = ROOT
    if alone:  # a directory holding chip_smoke.py and nothing of the repo
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("module,name", [
    ("align.lookup", "build_index"),
    ("asm.polish", "polish_indels"),
    ("asm.patch", "_DPBatch"),
    ("asm.patch", "patch_scaffold_gaps"),
    ("asm.assisted", "place_contigs"),
    ("asm.assisted", "assisted_patch"),
    ("asm.assisted", "assist_assembly"),
    ("asm.longread", "consensus_patch"),
    ("asm.longread", "close_gap_with_long_reads"),
    ("long.consensus", "score_stack"),
    ("long.consensus", "refine_consensus"),
    ("ec.jump", "error_correct_jumps"),
    ("eval.accuracy", "_genome_kmer_table"),
    ("eval.accuracy", "evaluate"),
    ("eval.accuracy", "base_error_report"),
    ("graph.unipath", "build_unipaths"),
    ("long.friends", "find_friends"),
    ("long.longproto", "long_proto"),
    ("long.ultra", "friend_hits"),
    ("long.ultra", "_banded_votes"),
    ("long.ultra", "correct_round"),
    ("long.ultra", "correct_long_reads"),
    ("tune_count", "measure"),
])
def test_entry_points_default_to_the_card(module, name):
    """The port's functions that take a device run on the card unless the
    caller asks for the CPU."""
    import importlib
    import inspect

    fn = getattr(importlib.import_module(f"allpathslg_tpu_torch.{module}"),
                 name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_make_mesh_needs_a_card_unless_cpu_is_asked(device):
    """The mesh's shards go on the card; without one, make_mesh raises
    unless device="cpu" is given (no fallback to the CPU)."""
    torch = pytest.importorskip("torch")
    from allpathslg_tpu_torch.parallel import mesh as pmesh

    if device == "cpu":
        m = pmesh.make_mesh(8, device="cpu")
        assert m.size == 8 and m.platform == "cpu"
        assert all(d == torch.device("cpu") for d in m.devices)
        return
    if torch.cuda.is_available():
        m = pmesh.make_mesh(8)
        assert all(d.type == "cuda" for d in m.devices)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh(8, device="cuda")


@pytest.mark.parametrize("device,dry", [("cuda", True), ("cpu", True),
                                        ("cpu", False)])
def test_tune_count_needs_a_card_unless_cpu_is_asked(tmp_path, device, dry):
    """The tuner runs on the card; without one it exits non-zero unless
    --device cpu is given. It saves the winner to $APLG_TUNING_FILE only,
    and with --dry writes nothing."""
    import json

    torch = pytest.importorskip("torch")
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tuner would run for real")
    user = tmp_path / "kernel_tuning.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT), APLG_TUNING_FILE=str(user))
    argv = [sys.executable, "-m", "allpathslg_tpu_torch.tune_count",
            "--device", device, "--reads", "256", "--read-len", "40",
            "--reps", "1"] + (["--dry"] if dry else [])
    r = subprocess.run(argv, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=120)
    if device == "cuda":
        assert r.returncode != 0
        assert "no CUDA device" in r.stderr
        assert not user.exists()
        return
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["device"] == "cpu" and res["kmers"] == 256 * (40 - 24 + 1)
    assert res["winner"] in ("flat", "bucketed")
    if dry:
        assert not user.exists()
    else:
        assert json.loads(user.read_text()) == {"count_engine": res["winner"]}
