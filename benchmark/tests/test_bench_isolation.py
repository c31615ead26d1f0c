"""The benchmark imports neither jax nor the JAX package, and its reference
imports nothing of the program: an AST scan of every file under benchmark/,
top-level module names compared whole (ma_tpu_torch is not ma_tpu)."""
import ast
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ma_tpu"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".", 1)[0])
    return tops


SOURCES = sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_import(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    tops = imported_tops(path)
    assert "ma_tpu_torch" not in tops
    assert tops <= {"__future__", "dataclasses", "math", "re", "numpy"}


def test_whole_name_comparison(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import ma_tpu_torch.kernels\nfrom ma_tpu_torch import cli\n")
    assert not imported_tops(probe) & FORBIDDEN
    probe.write_text("from ma_tpu.ops import dp\n")
    assert imported_tops(probe) & FORBIDDEN == {"ma_tpu"}


def test_run_checks_loaded_modules():
    import sys

    sys.path.insert(0, str(BENCH_DIR))
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["ma_tpu_torch_probe"] = object()
        assert "ma_tpu_torch_probe" not in run.forbidden_modules()
        sys.modules["ma_tpu.probe"] = object()
        assert "ma_tpu.probe" in run.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]
