"""Nothing in the benchmark imports JAX or the JAX package ``repro``, and
the reference imports nothing of the port. Names are compared by their
top-level part, whole: ``repro_torch`` begins with ``repro``."""
import ast
import sys
from pathlib import Path

import pytest

from bench import harness

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".", 1)[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in str(p))


def test_the_scan_sees_the_benchmark():
    names = {n for p in SOURCES for n in top_level_imports(p)}
    assert {"torch", "bench", "repro_torch"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(top_level_imports(path))
    assert "repro_torch" not in names
    assert names <= {"__future__", "typing", "torch", "bench"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import repro_torch  # noqa: F401  (its name begins with "repro")

    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    monkeypatch.setitem(sys.modules, "jaxlib_helper", object())
    found = harness.forbidden_modules()
    assert "repro" in found and "jaxlib" not in found


def test_the_port_loads_without_jax():
    """The entry points the adapters load pull in neither JAX nor the JAX
    package, in a fresh interpreter."""
    import subprocess

    code = ("import sys, torch; sys.path[:0] = ['src', '.'];"
            "import bench.harness as h;"
            "import repro_torch.kernels.skipper_match.ops,"
            " repro_torch.core.skipper, repro_torch.graphs.windows;"
            "print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
