"""Nothing the benchmark runs imports the JAX stack or the JAX package, and
the reference imports nothing of the program. Names are compared by their
top-level part whole: ``multimodalanalytical_tpu_torch`` is the program, not
the JAX package ``multimodalanalytical_tpu``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_STACK = {"jax", "jaxlib", "flax", "optax", "multimodalanalytical_tpu"}
PROGRAM = "multimodalanalytical_tpu_torch"
SOURCES = sorted(p for p in ROOT.rglob("*.py") if "tests" not in p.relative_to(ROOT).parts)


def imported(path: Path) -> set:
    """Top-level names of every absolute import in the file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources_found():
    assert any(p.name == "run.py" for p in SOURCES)
    assert any(p.parent.name == "reference" for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not imported(path) & JAX_STACK


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name == "reference"],
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert PROGRAM not in imported(path)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_reads_no_jax_benchmark(path):
    text = path.read_text()
    assert "bench.py" not in text and "BENCH_" not in text and "benchmarks/" not in text
