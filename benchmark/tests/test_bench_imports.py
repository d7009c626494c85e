"""No module of the benchmark imports `jax`, `jaxlib`, `flax` or the JAX
package `pcrhpg24_tpu`, and the reference imports nothing of the port:
names compared whole, the part before the first dot (the port's
`pcrhpg24_tpu_torch` begins with the JAX package's name)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pcrhpg24_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "pcrhpg24_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "math", "numpy", "torch"}


def test_names_compared_whole(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import pcrhpg24_tpu_torch.app\nfrom pcrhpg24_tpu import x\n")
    assert top_level_imports(p) & FORBIDDEN == {"pcrhpg24_tpu"}
