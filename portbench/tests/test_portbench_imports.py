"""Nothing under portbench/ imports JAX or the JAX package (the top-level
name of each module compared whole: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

FILES = sorted(p for p in (harness.HERE).rglob("*.py"))


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_import(path):
    assert not imported_tops(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_port():
    ref = harness.HERE / "reference.py"
    assert imported_tops(ref) <= {"__future__", "numpy"}
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " import portbench.reference;"
         " print(sorted({m.split('.')[0] for m in sys.modules}))",
         str(harness.ROOT)], capture_output=True, text=True, check=True)
    assert "allpathslg_tpu_torch" not in out.stdout
    assert "'allpathslg_tpu'" not in out.stdout


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "allpathslg_tpu_torch_x", sys)
    assert "allpathslg_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "allpathslg_tpu.pipeline", sys)
    assert "allpathslg_tpu.pipeline" in harness.forbidden_modules()
