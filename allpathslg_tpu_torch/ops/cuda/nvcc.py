"""Build a hand-written CUDA source of the port into a plain-C shared
library with nvcc, for Hopper (sm_90a), at first use.

Each kernel module names its source under `allpathslg_tpu_torch/csrc/`,
declares its C functions' types in a `bind`, and loads the library through
`library = loader(_SOURCE, bind)`. The library lands in `build/kernels/`
(gitignored) by native/build.compile_library, the compile routine the host
libraries share, under a name that carries a hash of the source and the
flags. `check` raises on a nonzero return of a kernel library's function.
`build_variant` builds edited copies of a source for the tuning scripts
under scripts/.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from allpathslg_tpu_torch.native.build import Loader, compile_library

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return path


def build(source: str) -> tuple:
    """Compile `csrc/<source>` if its library is missing: (path, seconds
    spent; 0.0 when the library was already built)."""
    return compile_library(_nvcc(), CSRC / source, NVCC_FLAGS, BUILD_DIR)


def loader(source: str, bind) -> Loader:
    """The `library()` of `csrc/<source>`: built, loaded and bound once, on
    first use."""
    return Loader(build, source, bind)


def check(err: int, what: str, error_string=None) -> None:
    """Raise if `what` returned the CUDA error `err` (nonzero), with the
    message of the library's `<name>_error_string` when it has one."""
    if err != 0:
        msg = f" ({error_string(err).decode()})" if error_string else ""
        raise RuntimeError(f"{what} failed: CUDA error {err}{msg}")


def build_variant(source: str, variant: str = "", ptxas: bool = False,
                  text: str | None = None) -> Path:
    """Compile a variant of `csrc/<source>` for a tuning script: a copy in
    which each NAME=VALUE of the comma-separated `variant` sets the
    constant `constexpr int NAME` ("" is the source as it is), or `text`
    as given, under build/tune_<stem>/. With `ptxas`, adds -Xptxas -v and
    prints its report (registers, shared memory, spills). Returns the
    library's path; a failed build raises."""
    stem = Path(source).stem
    src = (CSRC / source).read_text() if text is None else text
    for setting in filter(None, variant.split(",")):
        name, value = setting.split("=")
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {int(value)};", src)
        if n != 1:
            raise RuntimeError(f"{name} not found in {source}")
    out_dir = BUILD_DIR.parent / f"tune_{stem}"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = re.sub(r"[^A-Za-z0-9]+", "_", variant) or "source"
    if text is not None:
        tag += "_" + hashlib.sha1(text.encode()).hexdigest()[:8]
    cu = out_dir / f"{stem}_{tag}.cu"
    cu.write_text(src)
    lib = out_dir / f"lib{stem}_{tag}.so"
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if ptxas else [])
    proc = subprocess.run([_nvcc(), *flags, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {cu}:\n{proc.stderr}")
    if ptxas:
        print(f"[ptxas] {stem} {variant or 'source'}:\n"
              f"{proc.stderr.strip()}", flush=True)
    return lib
