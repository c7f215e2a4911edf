"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: `l2n_tpu_torch` is the port), and the
reference and the work counts import nothing of the port."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FILES = sorted(PKG.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_walk_sees_the_benchmark():
    rel = {p.relative_to(PKG).as_posix() for p in FILES}
    assert {"run.py", "harness.py", "reference/tracer.py",
            "counts/floor.py"} <= rel


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(PKG)
                         .as_posix())
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax",
                                          "l2n_tpu"}


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name in
                                  ("reference", "counts")],
                         ids=lambda p: p.relative_to(PKG).as_posix())
def test_reference_and_counts_import_nothing_of_the_port(path):
    assert "l2n_tpu_torch" not in top_level_imports(path)


def test_whole_names_are_compared():
    from portbench.harness import FORBIDDEN
    assert "l2n_tpu" in FORBIDDEN and "l2n_tpu_torch" not in FORBIDDEN
