"""Run one cell and build its result line.

A driver (``drivers/<name>.py``) runs the program and hands back an
observation: the window's calls and times, the program's counters, the
trace's summary per rank, the peak memory and the comparison of the
sampled outputs with the reference.  The metric readers named in
``BENCHMARK.json`` turn it into numbers; the configuration's limits
decide ``correct``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import sys
from typing import Dict, List, Optional, Tuple

from . import registry
from .env import say
from .window import beyond, nearest_rank


@dataclasses.dataclass
class Job:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    t0: float
    # "port" runs the program; "control" puts the reference, computed in
    # the next precision down, in its place (chipbench/reference)
    program: str = "port"
    # multi-process drivers: the script each rank runs (a test may give
    # one that breaks the program underneath first)
    rank_script: Optional[str] = None
    rank_args: List[str] = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "Job":
        return cls(**json.loads(text))


def _merge(base: dict, changes: dict) -> dict:
    out = copy.deepcopy(base)
    for key, value in changes.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _merge(out[key], value)
        else:
            out[key] = value
    return out


def plan(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
         t0: float, overrides: Optional[Dict[str, dict]] = None,
         **job_fields) -> Job:
    """The job of one run of ``cell``; ``overrides`` (tests only) merges
    into its ``config`` and ``traffic``."""
    w = registry.workload(bench, cell)
    config = registry.load_json("configs", w["config"])
    traffic = registry.load_json("traffic", w["traffic"])
    overrides = overrides or {}
    config = _merge(config, overrides.get("config", {}))
    traffic = _merge(traffic, overrides.get("traffic", {}))
    return Job(cell=w, config=config, traffic=traffic, seed=int(seed),
               seconds=float(seconds), trace=bool(trace), t0=t0,
               **job_fields)


def judge(compared: List[dict], limits: Dict[str, float]
          ) -> Tuple[Dict[str, dict], int]:
    """Each number's worst reading over the compared outputs beside its
    limit, and how many outputs broke a limit (a NaN breaks it)."""
    worst: Dict[str, float] = {}
    failed = 0
    for row in compared:
        bad = False
        for name, limit in limits.items():
            v = float(row[name])
            if math.isnan(v) or not v <= limit:
                bad = True
            if name not in worst or math.isnan(v) or v > worst[name]:
                worst[name] = v
        failed += bad
    return ({name: {"value": worst.get(name, float("nan")),
                    "limit": limits[name]} for name in limits}, failed)


def result_line(job: Job, bench: dict, obs: dict) -> dict:
    cell = job.cell["name"]
    section = (registry.per_layer_for if job.trace
               else registry.end_to_end_for)(bench, cell)
    metrics = {}
    for m in section:
        value = registry.load_module("metrics", m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    limits, failed = judge(obs["compared"], job.config["limits"])
    correct = (bool(obs["compared"]) and failed == 0
               and not obs["modules"])
    device = {"platform": obs["platform"], "kind": obs["kind"],
              "count": obs["chips"],
              "memory_peak_bytes": int(obs["peak_bytes"])}
    line = {"correct": correct, "attempted": obs["calls"], "failed": failed,
            "metrics": metrics, "device": device}
    summaries = [s for s in (obs.get("trace") or []) if s is not None]
    if job.trace and summaries:
        device["busy_s"] = sum(s["busy_s"] for s in summaries) / len(
            summaries)
        device["window_s"] = summaries[0]["window_s"]
        line["breakdown"] = {"device_ops": summaries[0]["device_ops"],
                             "idle_gaps": summaries[0]["idle_gaps"]}
    line["limits"] = limits
    return line


def report(job: Job, obs: dict, line: dict) -> None:
    """The earlier lines on standard error, then each number compared
    beside its limit as the last ones."""
    lat = obs["latencies_s"]
    if lat:
        say(f"window: {obs['calls']} calls in {obs['window_s']:.6f} s; "
            f"latency p50 {nearest_rank(lat, 50) * 1e3:.4f} ms, p95 "
            f"{nearest_rank(lat, 95) * 1e3:.4f} ms over {len(lat)} "
            f"samples, {beyond(lat, 95)} above p95")
        if len(lat) <= 64:
            say("call ms in order: " + " ".join(f"{x * 1e3:.1f}"
                                                for x in lat))
    say(f"setup: {obs['setup_s']:.3f} s; peak {obs['peak_bytes']} bytes")
    if obs.get("counters"):
        say("counters over the window: " + json.dumps(obs["counters"]))
    for note in obs.get("notes", []):
        say(note)
    for r, s in enumerate(obs.get("trace") or []):
        if s is not None:
            say(f"rank {r}: busy {s['busy_s']:.6f} s of a traced window "
                f"{s['window_s']:.6f} s, exposed collectives "
                f"{s['exposed_comm_s']:.6f} s, copies {s['copy_s']}")
    if obs["modules"]:
        say("forbidden modules loaded: " + ", ".join(obs["modules"]))
    say(f"compared {len(obs['compared'])} outputs, "
        f"{line['failed']} outside a limit; correct: {line['correct']}")
    for name, v in line["limits"].items():
        print(f"{name} {v['value']:.6e} limit {v['limit']:.6e}",
              file=sys.stderr, flush=True)


def execute(job: Job, bench: dict) -> dict:
    """Run the job's driver and return the result line (printing the
    earlier lines and the limits on standard error)."""
    driver = registry.load_module("drivers", job.config["driver"])
    obs = driver.run(job)
    line = result_line(job, bench, obs)
    report(job, obs, line)
    return line
