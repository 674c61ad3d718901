"""The port's one builder and loader of compiled libraries
(native/build.compile_library and Loader, ops/cuda/nvcc.build and loader).

Threads released together into a loader's first call, on an empty build
directory, get one library object, bound once, from one file named by the
hash of the source and the flags; no temporary file is left. The nvcc route
runs a stand-in compiler, a script that copies a library g++ built, so that
it runs the same code on a host without nvcc. A failing compiler raises
with its stderr and leaves no file behind.
"""

import hashlib
import os
import stat
import subprocess
import sys
import threading
from pathlib import Path

import pytest

pytest.importorskip("torch")

from allpathslg_tpu_torch.native import build as nbuild  # noqa: E402
from allpathslg_tpu_torch.ops.cuda import nvcc  # noqa: E402

THREADS = 8
NATIVE_SRC = Path(nbuild.__file__).parent / "fastq_reader.cpp"

# Stand-in for nvcc: pauses so that the threads meet inside the build,
# notes the run, then acts on the path after -o
STAND_IN = """#!{python}
import shutil, sys, time
time.sleep(0.2)
with open({runs!r}, "a") as f:
    f.write("run\\n")
out = sys.argv[sys.argv.index("-o") + 1]
{body}
"""
COPY = "shutil.copyfile({so!r}, out)"
FAIL = ('open(out, "w").write("half a library")\n'
        'sys.stderr.write("stand-in nvcc: no such option\\n")\n'
        "sys.exit(1)")


def _stand_in(tmp_path: Path, monkeypatch, body: str) -> Path:
    """Point nvcc.build at a stand-in compiler with `body`; the file its
    runs are noted in."""
    runs = tmp_path / "runs"
    script = tmp_path / "nvcc"
    script.write_text(STAND_IN.format(python=sys.executable, runs=str(runs),
                                      body=body))
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(nvcc, "_nvcc", lambda: str(script))
    return runs


def _prebuilt(tmp_path: Path) -> Path:
    so = tmp_path / "prebuilt.so"
    subprocess.run(["g++", *nbuild.CXX_FLAGS, "-o", str(so),
                    str(NATIVE_SRC)], check=True)
    return so


def _together(fn):
    """fn() from THREADS threads released at once: each one's result or
    RuntimeError."""
    barrier = threading.Barrier(THREADS)
    got = [None] * THREADS

    def run(i):
        barrier.wait(timeout=60)
        try:
            got[i] = fn()
        except RuntimeError as e:
            got[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(THREADS)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    return got


def _name(src: Path, flags: list) -> str:
    tag = hashlib.sha1(src.read_bytes()
                       + " ".join(flags).encode()).hexdigest()[:12]
    return f"lib{src.stem}_{tag}.so"


@pytest.mark.parametrize("route", ["g++ loader", "nvcc loader",
                                   "nvcc build", "failing nvcc"])
def test_first_use_from_threads(route, tmp_path, monkeypatch):
    out = tmp_path / "out"
    binds = []

    def bind(lib):
        binds.append(lib)
        return lib

    if route == "g++ loader":
        monkeypatch.setattr(nbuild, "BUILD_DIR", out)
        want = _name(NATIVE_SRC, nbuild.CXX_FLAGS)
        got = _together(nbuild.Loader(nbuild.build, NATIVE_SRC.stem, bind))
        runs = None
    else:
        monkeypatch.setattr(nvcc, "BUILD_DIR", out)
        want = _name(nvcc.CSRC / "pileup.cu", nvcc.NVCC_FLAGS)
        body = FAIL if route == "failing nvcc" else COPY.format(
            so=str(_prebuilt(tmp_path)))
        runs = _stand_in(tmp_path, monkeypatch, body)
        if route == "nvcc build":
            got = _together(lambda: nvcc.build("pileup.cu")[0])
        else:
            got = _together(nvcc.loader("pileup.cu", bind))

    if route == "failing nvcc":
        assert all(isinstance(e, RuntimeError) for e in got)
        assert all("nvcc failed for" in str(e)
                   and "stand-in nvcc: no such option" in str(e)
                   for e in got)
        assert sorted(os.listdir(out)) == []
        return
    assert sorted(os.listdir(out)) == [want]
    if route == "nvcc build":
        assert got == [out / want] * THREADS
        return
    assert all(g is got[0] for g in got), got
    assert binds == [got[0]]
    assert Path(got[0]._name) == out / want
    if runs is not None:
        assert runs.read_text().count("run") == 1
