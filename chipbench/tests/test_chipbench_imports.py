"""Nothing the benchmark runs loads JAX or the JAX package, and the
command refuses to run where it cannot measure the port on a card."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from yardstick import env, registry

FILES = sorted(registry.BENCH_DIR.rglob("*.py"))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield node.lineno, arg.value.split(".")[0]


def test_the_scan_sees_the_harness():
    names = {p.name for p in FILES}
    assert {"run.py", "ring.py", "blas_context.py", "gemm.py",
            "trace.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(registry.BENCH_DIR)))
def test_no_file_imports_jax_or_the_jax_package(path):
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in env.FORBIDDEN]
    assert not bad, f"{path}: {bad}"


def test_the_scan_compares_whole_top_level_names(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import repro_torch.api\nfrom repro.core import x\n"
                 "import jaxtyping\nimport jax.numpy\n")
    roots = [r for _, r in _imported_roots(p)]
    assert [r for r in roots if r in env.FORBIDDEN] == ["repro", "jax"]


def test_forbidden_modules_reads_this_process(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro_torch_fake" not in env.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert "flax.linen" in env.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time; sys.path.insert(0, 'chipbench');"
        "from yardstick import cell, env, registry;"
        "env.prepare(registry.REPO);"
        "from conftest import SMALL_DGEMM, with_dgemm;"
        "b = with_dgemm(registry.load_benchmark());"
        "j = cell.plan(b, 'dgemm16k-resident', 5, 0.1, True, "
        "time.perf_counter(), overrides=SMALL_DGEMM);"
        "line = cell.execute(j, b);"
        "print(env.forbidden_modules(), line['correct'])")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=registry.REPO, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(registry.BENCH_DIR / "tests")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[] True"


def _run(cwd: Path, *args):
    return subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", "ring-sgemm16k-x4",
         "--seed", "3000000017", "--seconds", "1", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_the_command_refuses_without_cards():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this reads the refusal without one")
    proc = _run(registry.REPO)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA card" in proc.stderr


def test_the_command_refuses_without_the_port(tmp_path):
    shutil.copy(registry.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.BENCH_DIR, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_the_command_takes_the_contracts_arguments():
    bench = registry.load_benchmark()
    assert bench["command"] == ["python3", "chipbench/run.py"]
    proc = subprocess.run([sys.executable, "chipbench/run.py", "--help"],
                          cwd=registry.REPO, capture_output=True, text=True,
                          timeout=120)
    for flag in ("--workload", "--seed", "--seconds", "--trace"):
        assert flag in proc.stdout
    assert json.loads(json.dumps(bench)) == bench
