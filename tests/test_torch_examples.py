"""The port's examples (``examples/torch_*.py``), each run as a user
runs it, with ``--device cpu`` at its smallest size: it exits 0 and
prints what it promises.  On the card the same scripts run without
``--device cpu``."""
import os
import subprocess
import sys

import pytest

from torch_ranks import REPO

CASES = {
    "torch_quickstart.py": (["--n", "64"], "cblas_dgemm max|err|"),
    "torch_pod_gemm.py": (["--ranks", "2"], "ring   max|err|"),
    "torch_serve_lm.py": ([], "served 10 requests / 120 tokens"),
    "torch_train_lm.py": (["--steps", "20", "--mesh", "2x1"],
                          "(20 steps, last ckpt @ 0)"),
}


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_runs_on_the_cpu(script, tmp_path):
    flags, promise = CASES[script]
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / script), "--device", "cpu",
         *flags], capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert promise in proc.stdout, proc.stdout[-2000:]


def test_examples_import_neither_jax_nor_the_reference():
    for script in CASES:
        text = (REPO / "examples" / script).read_text(encoding="utf-8")
        for line in text.splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "repro"), (
                    script, line)
