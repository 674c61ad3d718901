"""The port imports torch and never jax; the reference never imports torch;
chip_smoke.py refuses to run without a CUDA device."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

PORT_MODULES = [
    "allpathslg_tpu_torch",
    "allpathslg_tpu_torch.convert",
    "allpathslg_tpu_torch.dtypes.devcache",
    "allpathslg_tpu_torch.dtypes.packed",
    "allpathslg_tpu_torch.dtypes.reads",
    "allpathslg_tpu_torch.ec.precorrect",
    "allpathslg_tpu_torch.ec.spectrum_ec",
    "allpathslg_tpu_torch.eval.sim",
    "allpathslg_tpu_torch.kmer.bits",
    "allpathslg_tpu_torch.kmer.count",
    "allpathslg_tpu_torch.kmer.kmerize",
    "allpathslg_tpu_torch.kmer.spectrum",
    "allpathslg_tpu_torch.models.flagship",
    "allpathslg_tpu_torch.ops.cuda.sort_cuda",
    "allpathslg_tpu_torch.ops.join",
    "allpathslg_tpu_torch.ops.segmented",
    "allpathslg_tpu_torch.ops.sort",
    "allpathslg_tpu_torch.pipeline.config",
    "allpathslg_tpu_torch.pipeline.run",
    "allpathslg_tpu_torch.pipeline.rundir",
    "allpathslg_tpu_torch.pipeline.stages",
]

REFERENCE_MODULES = [m.replace("allpathslg_tpu_torch", "allpathslg_tpu")
                     for m in PORT_MODULES
                     if m.split(".")[-1] not in ("convert", "sort_cuda")] + [
    "allpathslg_tpu.ops.pallas.sort_pallas",
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
