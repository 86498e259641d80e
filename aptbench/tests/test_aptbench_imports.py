"""The benchmark never loads the JAX package or JAX, and its reference
loads nothing of the program under test: compared by whole top-level
module names, since the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

from aptbench import harness

HERE = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "noaa_apt_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_side_import(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX_SIDE | {"noaa_apt_tpu_torch"})


def test_names_compared_whole(tmp_path):
    """``noaa_apt_tpu_torch`` is not ``noaa_apt_tpu``; ``jaxlib.x`` is ``jaxlib``."""
    src = tmp_path / "m.py"
    src.write_text("import noaa_apt_tpu_torch.cli\nimport numpy\nfrom jaxlib import xla_client\n")
    assert top_level_imports(src) & JAX_SIDE == {"jaxlib"}


def test_forbidden_modules_reads_sys_modules(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "noaa_apt_tpu_torch_fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "noaa_apt_tpu.core", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["noaa_apt_tpu"]
