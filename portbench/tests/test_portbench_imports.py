"""Nothing the benchmark runs imports JAX or the JAX package, and the
references import nothing of the program.  Top-level names are compared
whole: ``reagent_tpu_torch`` begins with ``reagent_tpu`` and is the program."""

import ast
import sys
from pathlib import Path

from portbench import harness

HERE = harness.HERE
JAX_SIDE = {"jax", "jaxlib", "flax", "optax", "reagent_tpu"}


def imported_top_levels(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def sources(folder: Path):
    return sorted(p for p in folder.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(HERE)): sorted(set(imported_top_levels(p)) & JAX_SIDE)
             for p in sources(HERE)}
    assert not {k: v for k, v in found.items() if v}


def test_the_references_import_nothing_of_the_program():
    for p in sources(HERE / "reference"):
        names = set(imported_top_levels(p))
        assert "reagent_tpu_torch" not in names, p
        assert names <= {"__future__", "contextlib", "typing", "torch", "portbench"}, (p, names)
        # within the benchmark, a reference reads only other references
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), (p, node.module)


def test_the_run_time_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "reagent_tpu_torch_lookalike", object())
    assert "reagent_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "reagent_tpu.ops", object())
    assert harness.forbidden_modules() == ["reagent_tpu"]
