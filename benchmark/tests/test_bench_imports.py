"""Nothing of the benchmark imports JAX or the JAX package; the reference
imports nothing of the program either. Top-level names compared whole:
``var_tpu_torch`` is not ``var_tpu``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "var_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "var_tpu_torch" not in top_level_imports(path)


def test_whole_names_are_compared():
    src = "import var_tpu_torch.models\nfrom var_tpu_torch import config\n"
    p = BENCH / "out" / "probe_imports.py"
    p.parent.mkdir(exist_ok=True)
    p.write_text(src)
    try:
        assert top_level_imports(p) == {"var_tpu_torch"}
        assert not top_level_imports(p) & FORBIDDEN
    finally:
        p.unlink()


def test_the_run_refuses_a_loaded_jax_package(monkeypatch):
    import sys

    import benchmark.run as R

    monkeypatch.setitem(sys.modules, "var_tpu.ops", object())
    assert R.forbidden_modules() == ["var_tpu"]
