"""Find the pieces of a cell by the names in ``BENCHMARK.json``.

Each piece is a file of its own under ``chipbench/``:

  ``configs/<config>.json``   the deployment: sizes, dtype, its driver
  ``traffic/<traffic>.json``  the mix: operand placement, warm-up, sample
  ``drivers/<driver>.py``     the entry into the program: ``run(job)``
  ``metrics/<metric>.py``     a reader: ``read(obs) -> float | None``

A later cell adds files; it never edits one that is there.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
KINDS = {"configs": ".json", "traffic": ".json", "drivers": ".py",
         "metrics": ".py"}

_modules: Dict[str, ModuleType] = {}


def load_benchmark(repo: Path = REPO) -> dict:
    with open(repo / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def path_of(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> Path:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = bench_dir / kind / f"{name}{KINDS[kind]}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return path


def load_json(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(path_of(kind, name, bench_dir), encoding="utf-8") as f:
        return json.load(f)


def load_module(kind: str, name: str,
                bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module of ``<kind>/<name>.py``, loaded once per process."""
    path = path_of(kind, name, bench_dir)
    key = f"chipbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    mod = _modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[key] = mod
    return mod


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_for(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if _in_cell(m, cell)]


def per_layer_for(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and
    those that list no cells, where the cell reports what they move."""
    reported = {m["name"] for m in end_to_end_for(bench, cell)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in reported:
            out.append(m)
    return out
