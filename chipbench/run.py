#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

  python3 chipbench/run.py --workload ring-sgemm16k-x4 --seed 7 --seconds 51 --trace 0

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: loads
the port, makes the cell's inputs from ``--seed``, warms up, measures a
closed-loop window of ``--seconds`` (``--trace 1``: profiles a short
stretch of calls instead), compares sampled outputs with the plain
reference under ``chipbench/reference``, and prints one JSON line last
on standard output; the numbers compared, each with its limit, are the
last lines on standard error.  Needs as many CUDA cards as the cell
asks for, and exits non-zero without them, without the port beside it,
or when JAX or the JAX package got loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))

from yardstick import cell, env, registry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    repo = BENCH_DIR.parent
    bench = registry.load_benchmark(repo)
    job = cell.plan(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace), T0)
    env.prepare(repo)
    import torch
    chips = int(job.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        env.say(f"{args.workload} needs {chips} CUDA card(s); this machine "
                f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    env.say(f"cards: {env.card_line()}; torch {torch.__version__}, cuda "
            f"{torch.version.cuda}")
    line = cell.execute(job, bench)
    here = env.forbidden_modules()
    if here:
        env.say("forbidden modules loaded in the reporting process: "
                + ", ".join(here))
        return 4
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
