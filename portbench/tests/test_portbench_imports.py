"""No module a run imports has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``annembed_tpu`` (whole names: ``annembed_tpu_torch`` is
not ``annembed_tpu``), and the reference imports nothing of the
program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

BASE = Path(__file__).resolve().parents[1]
ROOT = BASE.parent


def _top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BASE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BASE)))
def test_no_forbidden_import(path):
    assert not _top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BASE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert "annembed_tpu_torch" not in names
    assert names <= {"__future__", "numpy", "torch"}


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "annembed_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxfoo", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "annembed_tpu.knn", object())
    assert harness.forbidden_modules() == ["annembed_tpu"]


def test_a_run_loads_no_forbidden_module():
    """A whole run on the CPU at a tiny size, in a fresh process."""
    code = (
        "import sys, json\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        "from portbench.tests.conftest import tiny\n"
        "harness.run_cell(Path('.'), 'higgs11m.hier', 3, 0.0, False, 0.0,"
        " device='cpu', overrides=tiny('higgs11m'), log=lambda m: None)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True).stdout
    loaded = set(__import__("json").loads(out.strip().splitlines()[-1]))
    assert "annembed_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)
