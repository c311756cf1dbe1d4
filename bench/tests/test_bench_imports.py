"""Nothing under bench/ imports JAX or the JAX package: every import's
top-level name, the part before the first dot, is compared whole, so the
port (``repro_torch``) passes and ``repro`` does not."""
import ast
from pathlib import Path

import pytest

import harness

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.core\nfrom repro_torch import kernels\nimport jaxtyping\n")
    assert not top_level_imports(src) & FORBIDDEN
    src.write_text("from repro.core import sweep\n")
    assert top_level_imports(src) & FORBIDDEN == {"repro"}


def test_the_run_looks_at_the_loaded_modules(monkeypatch):
    import sys
    import types

    assert harness.forbidden_modules() == [] or "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torchx", types.ModuleType("repro_torchx"))
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in harness.forbidden_modules()
