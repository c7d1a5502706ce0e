"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program under test.

Module names are compared by their top-level part (before the first dot),
whole: ``qpth_tpu_torch`` begins with ``qpth_tpu`` and is not it."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "qpth_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    """(top-level name, line) of every absolute import in the file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_sources_found():
    assert BENCH / "run.py" in SOURCES
    assert any(p.parent.name == "reference" for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax(path):
    bad = [(name, line) for name, line in top_level_imports(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if p.parent.name == "reference"],
    ids=lambda p: p.name)
def test_reference_is_independent(path):
    tree = ast.parse(path.read_text())
    relative = [n.lineno for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.level > 0]
    names = {name for name, _ in top_level_imports(path)}
    assert "qpth_tpu_torch" not in names
    assert not relative, f"{path.name} imports from its package"
    assert names <= {"torch", "__future__"}, names


def test_compares_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import qpth_tpu_torch\n"
                     "from qpth_tpu_torch.ops import kkt\n"
                     "import jax.numpy\n")
    names = {n for n, _ in top_level_imports(probe)}
    assert names == {"qpth_tpu_torch", "jax"}
    assert names & FORBIDDEN == {"jax"}
