"""Shared set-up of the benchmark's own tests.

Run them from the root of the repository:

  python -m pytest -q chipbench/tests            # here, on the CPU
  python -m pytest -q -m cuda chipbench/tests    # on a machine with cards
"""
import copy
import sys
import time
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

from yardstick import cell, env, registry  # noqa: E402

env.prepare(registry.REPO)

# small sizes at which a whole run takes well under a second on the CPU
SMALL_DGEMM = {"config": {"m": 96, "n": 64, "k": 80, "tile": 32,
                          "runtime": {"device": "cpu",
                                      "cache_bytes": 1 << 26}}}
SMALL_RING = {"config": {"m": 64, "n": 48, "k": 64, "device": "cpu"}}


# the DGEMM cells: their files are here, but BENCHMARK.json leaves them
# out because their runs spread too widely on the measuring machines
# (PERF.md); these entries, as BENCHMARK.json would hold them, keep
# their path tested
DGEMM_CONFIG = {"name": "dgemm_n16384_t1024",
                "source": "https://arxiv.org/abs/1510.05041",
                "file": "chipbench/configs/dgemm_n16384_t1024.json",
                "reduced": [],
                "why": "the paper's DGEMM regime through BlasxContext"}
DGEMM_CELLS = [
    {"name": "dgemm16k-host", "config": "dgemm_n16384_t1024",
     "traffic": "host_operands", "chips": 1,
     "why": "ctx.gemm on pageable host A and B every call"},
    {"name": "dgemm16k-resident", "config": "dgemm_n16384_t1024",
     "traffic": "resident_operands", "chips": 1,
     "why": "A, B0, B1 tiled once and warm; call i is A @ B(i mod 2)"},
]
DGEMM_LAYERS = [
    ("h2d_bytes_per_call", "bytes", "lower", "program_counter",
     "scheduler and tile caches"),
    ("copy_ms_per_call", "ms", "lower", "device_trace", "copies"),
    ("launches_per_call", "launches", "lower", "program_counter",
     "taskization and dispatch"),
    ("gemm_kernel_roofline", "%", "higher", "device_trace",
     "K4 GEMM kernel"),
]


def with_dgemm(bench: dict) -> dict:
    """BENCHMARK.json with the DGEMM cells and their metrics beside the
    ring."""
    b = copy.deepcopy(bench)
    names = [w["name"] for w in DGEMM_CELLS]
    b["configs"].append(dict(DGEMM_CONFIG))
    b["workloads"] += copy.deepcopy(DGEMM_CELLS)
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("call_mfu", "device_idle_share"):
            m["workloads"] = m["workloads"] + names
    for name, unit, better, source, layer in DGEMM_LAYERS:
        b["per_layer"].append({"name": name, "unit": unit, "better": better,
                               "source": source, "layer": layer,
                               "moves": "tflops", "workloads": names})
    return b


@pytest.fixture(scope="session")
def bench():
    return registry.load_benchmark()


@pytest.fixture(scope="session")
def bench_plus(bench):
    return with_dgemm(bench)


@pytest.fixture
def run_cell(bench_plus):
    """Run a cell end to end at a small size on the CPU (the harness's
    look for a card skipped) and return its result line."""
    def go(name, *, trace=False, seconds=0.3, seed=2**31 + 7,
           overrides=None, **job_fields):
        small = SMALL_RING if name.startswith("ring") else SMALL_DGEMM
        job = cell.plan(bench_plus, name, seed, seconds, trace,
                        time.perf_counter(),
                        overrides=cell._merge(small, overrides or {}),
                        **job_fields)
        return cell.execute(job, bench_plus)
    return go
