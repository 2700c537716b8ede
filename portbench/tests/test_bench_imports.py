"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's own name begins with the JAX package's),
and neither the reference nor the harness's general code imports the
program: only the drivers reach the system under test."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_top_levels(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_imports_neither_jax_nor_the_jax_package(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name in ("reference", "harness")
                                  or p.parent.name == "metrics"],
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_reference_harness_and_readers_import_nothing_of_the_program(path):
    assert "repro_torch" not in imported_top_levels(path)


def test_the_check_compares_whole_names():
    from portbench.harness import runner

    assert set(runner.FORBIDDEN) == FORBIDDEN
    assert "repro_torch" not in runner.forbidden_modules()
