"""Whole runs on the CPU at small sizes: a sound run is correct; the
control (the reference one precision down in the program's place) and
every fault planted under the timed path are not."""
import json
import subprocess
import sys
from pathlib import Path

import faults
import pytest
from conftest import SMALL_DGEMM, SMALL_RING

from controls import readings

DGEMM_CELLS = ("dgemm16k-host", "dgemm16k-resident")
# k a multiple of the tile, so every k-chain is whole and "half" halves it
WHOLE_CHAINS = {"config": {"k": 128}}
FAULTS_PY = str(Path(faults.__file__).resolve())


@pytest.mark.parametrize("cell", DGEMM_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_dgemm_run_is_correct(run_cell, cell, trace):
    line = run_cell(cell, trace=trace)
    assert line["correct"] and line["failed"] == 0
    assert line["attempted"] >= 1
    assert list(line)[-1] == "limits"
    assert set(line["limits"]) == {"normwise", "maxrel"}
    want = ({"h2d_bytes_per_call", "launches_per_call"} if trace
            else {"tflops", "setup_s"})
    assert want <= set(line["metrics"])


@pytest.mark.parametrize("cell", DGEMM_CELLS)
@pytest.mark.parametrize("fault", faults.BLAS_FAULTS)
def test_a_broken_dgemm_path_is_not_correct(run_cell, monkeypatch, cell,
                                            fault):
    faults.plant_blas(fault, monkeypatch.setattr)
    line = run_cell(cell, overrides=WHOLE_CHAINS)
    assert line["correct"] is False and line["failed"] >= 1


@pytest.mark.parametrize("cell", DGEMM_CELLS)
def test_the_dgemm_control_is_not_correct(bench_plus, cell):
    rows = readings(cell, "control", [11, 12, 2**31 + 3], 0.2,
                    overrides=SMALL_DGEMM, bench=bench_plus)
    assert [r["correct"] for r in rows] == [False] * 3
    for r in rows:
        # float32 sums: far above float64's, far below a wrong answer
        assert 1e-9 < r["worst"]["normwise"] < 1e-5


def test_a_sound_ring_run_is_correct(run_cell):
    line = run_cell("ring-sgemm16k-x4", trace=True)
    assert line["correct"] and line["failed"] == 0
    assert line["metrics"]["p2p_hops_per_call"]["value"] == 3


@pytest.mark.parametrize("fault", faults.RING_FAULTS)
def test_a_broken_ring_is_not_correct(run_cell, fault):
    line = run_cell("ring-sgemm16k-x4", rank_script=FAULTS_PY,
                    rank_args=["--fault", fault])
    assert line["correct"] is False and line["failed"] >= 1


def test_the_ring_control_is_not_correct():
    rows = readings("ring-sgemm16k-x4", "control", [21, 2**31 + 5], 0.2,
                    overrides=SMALL_RING)
    assert [r["correct"] for r in rows] == [False, False]
    for r in rows:
        assert 1e-5 < r["worst"]["normwise"] < 1e-2


def test_the_ring_rehearsal_runs_through_gloo():
    proc = subprocess.run(
        [sys.executable, str(faults.BENCH_DIR / "drivers" / "ring.py"),
         "--rehearse", "--ranks", "4", "--n", "64", "--seconds", "0.3"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["failed"] == 0 and out["compared"] == 8
    assert out["collectives"]["p2p"] == 3 * out["calls"]
    assert "tflops" not in out
