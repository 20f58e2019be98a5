"""No module of the benchmark, its reference or its tests loads JAX or the
JAX package; names are compared whole (the port's name begins with the
JAX package's); the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(harness.BENCH)
JAX_PACKAGE = "structured_light_for_3d_model_replication_tpu"
PORT = JAX_PACKAGE + "_torch"


def imported_tops(path: Path) -> set[str]:
    """Top-level names of every absolute import in ``path``."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_banned_names_compare_whole():
    assert harness.banned_modules([PORT, PORT + ".ops.nn", "jaxtyping",
                                   "benchmark.harness"]) == []
    assert harness.banned_modules([JAX_PACKAGE + ".ops", "jax.numpy",
                                   "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", JAX_PACKAGE]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax(path):
    assert not imported_tops(path) & set(harness.BANNED)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported_tops(path)
    assert "benchmark" not in imported_tops(path)
    text = path.read_text()
    assert "from .." not in text


def test_a_run_loads_no_jax():
    """Every module of the benchmark and the port's modules a cell drives,
    imported in a fresh process: nothing banned is loaded."""
    code = (
        "import sys, importlib, pkgutil; sys.path.insert(0, %r)\n"
        "import benchmark, benchmark.drivers\n"
        "for m in pkgutil.walk_packages(benchmark.__path__, 'benchmark.'):\n"
        "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
        "import %s.serve, %s.stream, %s.models.scan360\n"
        "from benchmark import harness\n"
        "print(harness.banned_modules())\n" % (str(harness.ROOT), PORT, PORT,
                                               PORT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """With no card the command exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         harness.manifest()["workloads"][0]["name"], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
