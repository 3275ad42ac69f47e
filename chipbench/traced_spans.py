#!/usr/bin/env python3
"""A cell's traced run with the program's spans reduced beside it.

  python3 chipbench/traced_spans.py --workload ring-sgemm16k-x4 --seed 7
  python3 chipbench/traced_spans.py --workload dgemm16k-resident --seed 7

Runs one cell as ``chipbench/run.py --trace 1`` does, through the same
driver and profiler options, with the driver's ``Tracer`` replaced by
``yardstick.spans.SpanTracer``: each rank's trace summary then also
holds the reduction of the program's ``blasx.*`` spans, and the ring's
counters also hold ``prep_bytes`` (``distributed.PREP_BYTES``).  Prints
the cell's result line (its per-layer metrics), then a table a span for
rank 0 and the ring's phases a call on standard error, and one JSON line
last on standard output: the result line, each rank's span reduction,
rank 0's phases a call (``spans.per_call``, and
``prep_bytes_per_call``) and the counters.  The DGEMM cells, which
``BENCHMARK.json`` leaves out, come from ``chipbench/tests/conftest.py``'s
``with_dgemm``.  ``--small`` runs the cell at the benchmark tests' CPU
size (gloo ranks for the ring); no number of such a run is a device
metric.

``chipbench/run.py``, which measures the cells, does not run this file
and keeps the plain ``Tracer``.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

from yardstick import cell, env, registry, spans  # noqa: E402


def _conftest():
    """The benchmark tests' shared set-up: the DGEMM cells and the CPU
    sizes."""
    if str(BENCH_DIR / "tests") not in sys.path:
        sys.path.insert(0, str(BENCH_DIR / "tests"))
    import conftest
    return conftest


@contextlib.contextmanager
def _swapped(obj, **attrs):
    """``obj`` with ``attrs`` set, put back as they were on leaving: a
    driver module stays cached for the process, and its later runs keep
    their own tracer."""
    kept = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield obj
    finally:
        for k, v in kept.items():
            setattr(obj, k, v)


def _port_counters(self) -> dict:
    """The ring driver's ``Port.counters`` with ``prep_bytes``, the
    program's ``PREP_BYTES``, where the program has it."""
    got = dict(self.dist.COLLECTIVES)
    if hasattr(self.dist, "PREP_BYTES"):
        got["prep_bytes"] = self.dist.PREP_BYTES
    return got


def run(bench: dict, workload: str, seed: int, overrides=None) -> dict:
    """The traced run's observation and result line, each rank's trace
    summary holding ``"spans"``."""
    # a traced run's calls are the mix's trace_calls: no window length
    job = cell.plan(bench, workload, seed, 0.0, True, T0,
                    overrides=overrides,
                    rank_script=str(Path(__file__).resolve()))
    env.prepare(BENCH_DIR.parent)
    driver = registry.load_module("drivers", job.config["driver"])
    # a one-process driver traces here; a ring's ranks run rank_main
    with _swapped(driver, Tracer=spans.SpanTracer):
        obs = driver.run(job)
    line = cell.result_line(job, bench, obs)
    cell.report(job, obs, line)
    return {"job": job, "obs": obs, "line": line}


def phases(got: dict) -> dict:
    """Rank 0's ring phases a call (``spans.per_call``) and the operand
    prep's new bytes a call, ``prep_bytes_per_call``, where the run has
    them."""
    summaries = got["obs"]["trace"] or []
    first = summaries[0].get("spans") if summaries and summaries[0] else None
    out = spans.per_call(first) if first else {}
    prep = got["obs"]["counters"].get("prep_bytes")
    if prep is not None:
        out["prep_bytes_per_call"] = prep / got["obs"]["calls"]
    return out


def table(reduced: dict) -> str:
    """One line a span name: count, host self ms, device ms, alone ms,
    each a call, and its largest device operations."""
    calls = reduced["calls"]
    rows = [f"{'span':24s} {'n/call':>7s} {'self ms':>9s} {'device ms':>10s}"
            f" {'alone ms':>9s}  self, device ms min-max over calls; "
            "largest device ops (ms a call)"]
    for name, r in sorted(reduced["names"].items(),
                          key=lambda kv: -kv[1]["device_s"]):
        ops = ", ".join(f"{op[:48]} {s / calls * 1e3:.4f}"
                        for op, s in r["device_ops"])
        spread = " ".join(
            f"{min(v) * 1e3:.4f}-{max(v) * 1e3:.4f}"
            for v in zip(*r["by_call"]))
        rows.append(f"{name:24s} {r['count'] / calls:7.2f} "
                    f"{r['self_s'] / calls * 1e3:9.4f} "
                    f"{r['device_s'] / calls * 1e3:10.4f} "
                    f"{r['alone_s'] / calls * 1e3:9.4f}  {spread}; {ops}")
    rows.append(f"outside any program span: "
                f"{reduced['outside_s'] / calls * 1e3:.4f} ms a call of "
                f"{reduced['busy_s'] / calls * 1e3:.4f} busy; idle by span: "
                + ", ".join(f"{n} {s / calls * 1e3:.4f}"
                            for n, s in reduced["idle_gaps"]))
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    bench = registry.load_benchmark()
    if args.workload not in [w["name"] for w in bench["workloads"]]:
        bench = _conftest().with_dgemm(bench)
    overrides = None
    if args.small:
        small = _conftest()
        overrides = (small.SMALL_RING if args.workload.startswith("ring")
                     else small.SMALL_DGEMM)
    got = run(bench, args.workload, args.seed, overrides)
    reduced = [s.get("spans") if s is not None else None
               for s in got["obs"]["trace"] or []]
    per_call = phases(got)
    if reduced and reduced[0]:
        env.say("rank 0's spans, a call over "
                f"{reduced[0]['calls']} calls:\n" + table(reduced[0]))
    env.say("phases a call: " + json.dumps(per_call))
    print(json.dumps({"line": got["line"], "spans": reduced,
                      "per_call": per_call,
                      "counters": got["obs"]["counters"]}), flush=True)
    return 0


def rank_main(argv) -> int:
    """One rank of the ring driver with the span tracer, its counters
    holding ``prep_bytes``."""
    ring = registry.load_module("drivers", "ring")
    with _swapped(ring, Tracer=spans.SpanTracer), \
            _swapped(ring.Port, counters=_port_counters):
        return ring.rank_main(argv)


if __name__ == "__main__":
    if "--job" in sys.argv[1:]:
        sys.exit(rank_main(sys.argv[1:]))
    sys.exit(main(sys.argv[1:]))
