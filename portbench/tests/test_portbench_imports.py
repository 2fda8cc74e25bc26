"""No file of the benchmark imports JAX, flax or the JAX package
(styl3r_tpu), compared by the whole top-level name: styl3r_tpu_torch, the
program, is allowed. The yardstick's reference and counts import nothing
of the program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "styl3r_tpu"}
FILES = sorted(HERE.rglob("*.py"))


def imported_top_names(path: Path):
    """The top-level module names a file imports (relative imports within
    portbench resolve to portbench)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("portbench" if node.level else node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name in ("reference", "counts")],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "styl3r_tpu_torch" not in imported_top_names(path)
    assert "styl3r_tpu_torch" not in path.read_text().replace("styl3r_tpu_torch/", "")


def test_the_top_level_name_is_compared_whole():
    assert "styl3r_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "styl3r_tpu.models".split(".")[0] in FORBIDDEN


def test_a_run_refuses_when_jax_was_loaded(monkeypatch):
    import sys
    import types

    from portbench import run

    monkeypatch.setitem(sys.modules, "styl3r_tpu", types.ModuleType("styl3r_tpu"))
    monkeypatch.setitem(sys.modules, "styl3r_tpu_torch_extra", types.ModuleType("styl3r_tpu_torch_extra"))
    assert run.forbidden_modules() == ["styl3r_tpu"]
