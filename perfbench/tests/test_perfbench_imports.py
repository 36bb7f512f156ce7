"""Nothing under perfbench/ imports JAX, the JAX package ``repro`` or the
JAX package's ``benchmarks`` (top-level names compared whole:
``repro_torch`` is not ``repro``), and the plain reference imports nothing
of the program."""
import ast
from pathlib import Path

import pytest

from perfbench.harness import runner

BENCH_DIR = Path(__file__).resolve().parents[1]
SOURCES = sorted(BENCH_DIR.rglob("*.py"))


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH_DIR)) for p in SOURCES])
def test_no_jax_anywhere(path):
    tops = set(imported_tops(path))
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


@pytest.mark.parametrize(
    "path", sorted((BENCH_DIR / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert "repro_torch" not in set(imported_tops(path))


def test_forbidden_names_compared_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("x"))
    assert "repro_torch_like" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("y"))
    assert runner.forbidden_modules() == ["repro.core"]
