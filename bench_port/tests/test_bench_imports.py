"""Nothing the benchmark runs loads JAX or the JAX package, and the
harness reads no file of the JAX package's benchmark."""

import os
import pathlib
import re
import subprocess
import sys

from conftest import BENCH, REPO


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from bench_port import harness

    monkeypatch.setitem(sys.modules, "dsr_tpu_torch_x", sys)
    assert "dsr_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dsr_tpu.ops", sys)
    assert "dsr_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_sources_import_nothing_forbidden():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|dsr_tpu|golden)\b(?!_)",
                     re.MULTILINE)
    for p in BENCH.rglob("*.py"):
        text = p.read_text()
        assert not bad.search(text), p
        if "tests" not in p.parts:      # nor names a file of the JAX package's benchmark
            assert not re.search(r"\bbench\.py\b|\btools/", text), p


def test_a_run_loads_nothing_forbidden(tmp_path):
    """Every tiny cell runs in a fresh interpreter: afterwards sys.modules
    holds no jax, jaxlib, flax, optax, dsr_tpu or golden."""
    code = f"""
import os, pathlib, sys
sys.path.insert(0, {str(REPO)!r}); sys.path.insert(0, {str(BENCH / 'tests')!r})
import conftest
from bench_port import harness

d = pathlib.Path({str(tmp_path)!r})
os.environ["DSR_TPU_TORCH_CACHE"] = str(d / "graphs")
bench, layout = conftest.twins(conftest.load("../BENCHMARK.json"), d)
for w in bench["workloads"]:
    conftest.run_tiny(bench, layout, w["name"])
print(harness.forbidden_modules())
"""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_py_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "v2k.batch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=REPO,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_py_needs_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and bench_port/, a run
    fails and prints no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "cache", "traces"))
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "v2k.batch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
