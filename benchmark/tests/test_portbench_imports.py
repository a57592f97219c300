"""The benchmark loads neither JAX nor the JAX package (top-level names compared whole,
so that kwave_tpu_torch passes), the reference imports nothing of the program, and the
command refuses to run without a card."""

import ast
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.portbench_helpers import ROOT, cells


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "kwave_tpu_torch_like", sys)
    assert "kwave_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "kwave_tpu.cli", sys)
    assert harness.forbidden_modules() == ["kwave_tpu.cli"]


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("kwave_tpu_torch", "kwave_tpu", "jax",
                                              "jaxlib", "flax"), (path.name, name)


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "benchmark").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path.name, name)


def test_a_run_loads_no_forbidden_module():
    """A whole run of every cell at a tiny size, in a fresh process."""
    code = ("import sys, json\n"
            "from benchmark.tests.portbench_helpers import run_tiny, cells\n"
            "from benchmark import harness\n"
            "for name in cells():\n"
            "    assert run_tiny(name, trace=True)['correct'], name\n"
            "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", cells())
def test_the_command_refuses_to_run_without_a_card(name):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(ROOT / "build")})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_the_command_refuses_a_checkout_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cells()[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
