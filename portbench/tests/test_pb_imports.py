"""Nothing of the benchmark imports JAX or the JAX package, by whole
top-level module name (``attendance_tpu_torch`` is the port and is
allowed; ``attendance_tpu`` is not)."""

import ast
import sys

from conftest import REPO
from portbench.run import FORBIDDEN, forbidden_modules


def imported_top_levels(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((REPO / "portbench").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        names = set(imported_top_levels(path))
        assert not names & set(FORBIDDEN), path
    driver = REPO / "portbench" / "drivers" / "fused_backlog.py"
    assert "attendance_tpu_torch" in set(imported_top_levels(driver))


def test_the_run_refuses_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "attendance_tpu_torch_x", sys)
    assert "attendance_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "attendance_tpu.config", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"attendance_tpu", "jax"} <= set(forbidden_modules())
