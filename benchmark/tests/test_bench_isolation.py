"""The benchmark loads no JAX, its reference nothing of the program, and
its entry point never runs without the card."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "pyrayt_tpu"}


def _imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def _modules():
    return [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts]


def _reference_modules():
    return list((BENCH / "reference").glob("*.py")) + list(BENCH.glob("configs/*_reference.py"))


@pytest.mark.parametrize("path", _modules(), ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    # top-level names compared whole: pyrayt_tpu_torch is not pyrayt_tpu
    assert not _imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", _reference_modules(),
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_the_reference_imports_nothing_of_the_program(path):
    names = _imported_top_names(path)
    assert "pyrayt_tpu_torch" not in names
    assert names <= {"__future__", "dataclasses", "math", "statistics", "typing", "numpy",
                     "torch", "benchmark"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith(
                "benchmark."):
            assert node.module.startswith(("benchmark.reference", "benchmark.configs"))


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "doublet.optimize", "--seed",
         "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_fails_without_a_card_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_are_found_by_whole_top_level_name():
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import runner

    saved = dict(sys.modules)
    try:
        sys.modules["pyrayt_tpu_torch_like"] = sys
        assert "pyrayt_tpu" not in runner.forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert runner.forbidden_modules() == ["jax"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
