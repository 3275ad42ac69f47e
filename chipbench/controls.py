#!/usr/bin/env python3
"""The readings a cell's limits are set from, many seeds in one process.

For each seed, runs the cell's driver at the cell's own size with a
short window and prints the worst of each compared number: with
``--program port`` the program (the lower readings), with ``--program
control`` the reference computed in the next precision below the
configuration's in the program's place (the upper readings; it has to
come out not correct).  The benchmark's own runs never run the control.

  python3 chipbench/controls.py --workload ring-sgemm16k-x4 --program control --seeds 11,12,13 --seconds 3
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))

from yardstick import cell, env, registry  # noqa: E402


def readings(workload: str, program: str, seeds, seconds: float,
             overrides=None, bench=None, **job_fields):
    """One row per seed: the worst of each number, how many outputs
    broke a limit, and ``correct``."""
    bench = bench or registry.load_benchmark()
    rows = []
    for seed in seeds:
        job = cell.plan(bench, workload, seed, seconds, False,
                        time.perf_counter(), overrides=overrides,
                        program=program, **job_fields)
        driver = registry.load_module("drivers", job.config["driver"])
        obs = driver.run(job)
        limits, failed = cell.judge(obs["compared"], job.config["limits"])
        rows.append({"workload": workload, "program": program, "seed": seed,
                     "calls": obs["calls"], "compared": len(obs["compared"]),
                     "failed": failed,
                     "correct": bool(obs["compared"]) and failed == 0,
                     "worst": {k: v["value"] for k, v in limits.items()},
                     "limits": {k: v["limit"] for k, v in limits.items()}})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", choices=("port", "control"),
                    default="control")
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    env.prepare(BENCH_DIR.parent)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for row in readings(args.workload, args.program, seeds, args.seconds):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
