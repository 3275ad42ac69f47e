"""Determinism lint (DT001/DT002) for the port's virtual-clock paths.

The discrete-event engine, the tuning layer and the sim-mode runtime
promise byte-identical replays: traces are diffed across runs, the
tuning cache must be portable between machines, shadow runs re-execute
recorded schedules, and the port's ledgers must equal the reference's.
One ``time.time()`` or ambient ``random.random()`` in those paths
breaks all of it silently.

Scope: modules under ``repro_torch/core/`` and ``repro_torch/tuning/``.
Threads mode *does* measure real wall time by design — those sites live
in ``core/runtime.py`` and are baselined with that justification rather
than exempted structurally, so a new wall-clock read anywhere else in
``core/`` still fails.

* **DT001** — any reference (call *or* bare function reference, which
  is how a clock leaks in as a default argument) to ``time.time``,
  ``time.perf_counter``, ``time.monotonic``, ``time.process_time``,
  ``datetime.now/utcnow/today``.
* **DT002** — ambient RNG: ``random.<anything>`` and
  ``np.random.<fn>`` / ``numpy.random.<fn>`` except the seeded
  constructors (``default_rng``, ``SeedSequence``, ``Generator``,
  ``PCG64``), and torch's global generator: ``torch.rand``, ``randn``,
  ``randint``, ``randperm``, ``normal``, ``bernoulli``, ``multinomial``
  unless called with ``generator=``, and ``torch.manual_seed`` /
  ``torch.seed``, which reseed it.  ``torch.Generator`` is the allowed
  idiom, as explicit numpy generators are.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from .findings import Finding, normalize_path

_WALL_CLOCK = {
    ("time", "time"), ("time", "perf_counter"), ("time", "monotonic"),
    ("time", "process_time"), ("time", "perf_counter_ns"),
    ("time", "monotonic_ns"), ("time", "time_ns"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("date", "today"),
}
_RNG_MODULES = {"random"}
_NP_RANDOM_OK = {"default_rng", "SeedSequence", "Generator", "PCG64",
                 "Philox"}
# torch functions that draw from (or reseed) the global generator; the
# drawing ones are fine with an explicit generator= keyword
_TORCH_RNG = {"rand", "randn", "randint", "randperm", "normal",
              "bernoulli", "multinomial"}
_TORCH_RESEED = {"manual_seed", "seed"}
_SCOPE_PREFIXES = ("repro_torch/core/", "repro_torch/tuning/")


def in_scope(relpath: str) -> bool:
    return relpath.startswith(_SCOPE_PREFIXES)


class _Visitor(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.relpath = relpath
        self.findings: List[Finding] = []
        self._stack: List[str] = []
        self._seen = set()  # (line, detail): a Call visits its
        # Attribute child too; report each site once
        self._seeded = set()  # ids of torch RNG callees given generator=

    def _qualname(self) -> str:
        return ".".join(self._stack) if self._stack else "<module>"

    def _emit(self, rule: str, node: ast.AST, detail: str, message: str):
        if (node.lineno, detail) in self._seen:
            return
        self._seen.add((node.lineno, detail))
        self.findings.append(Finding(
            rule=rule, path=self.relpath, line=node.lineno,
            qualname=self._qualname(), detail=detail, message=message))

    def visit_FunctionDef(self, node):
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    def _dotted(self, node: ast.Attribute) -> Optional[str]:
        if isinstance(node.value, ast.Name):
            return node.value.id
        if isinstance(node.value, ast.Attribute) and \
                isinstance(node.value.value, ast.Name):
            # np.random.rand -> receiver "np.random"
            return f"{node.value.value.id}.{node.value.attr}"
        return None

    def visit_Call(self, node: ast.Call):
        if isinstance(node.func, ast.Attribute) and \
                any(kw.arg == "generator" for kw in node.keywords):
            self._seeded.add(id(node.func))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute):
        recv = self._dotted(node)
        if recv == "torch" and (node.attr in _TORCH_RESEED or (
                node.attr in _TORCH_RNG and id(node) not in self._seeded)):
            self._emit(
                "DT002", node, f"torch.{node.attr}",
                f"ambient RNG torch.{node.attr} draws from (or reseeds) "
                "torch's global generator — pass generator=torch.Generator"
                "().manual_seed(seed) instead")
        elif recv is not None:
            if (recv, node.attr) in _WALL_CLOCK:
                self._emit(
                    "DT001", node, f"{recv}.{node.attr}",
                    f"{recv}.{node.attr} in a virtual-clock path — "
                    "sim/tuning code must take time from the event "
                    "engine, not the wall")
            elif recv in _RNG_MODULES:
                self._emit(
                    "DT002", node, f"{recv}.{node.attr}",
                    f"ambient RNG {recv}.{node.attr} in a virtual-clock "
                    "path — pass an explicit seeded generator instead")
            elif recv in ("np.random", "numpy.random") and \
                    node.attr not in _NP_RANDOM_OK:
                self._emit(
                    "DT002", node, f"{recv}.{node.attr}",
                    f"ambient RNG {recv}.{node.attr} — use "
                    "np.random.default_rng(seed) and thread it through")
        self.generic_visit(node)


def check_determinism(tree: ast.Module, relpath: str) -> List[Finding]:
    if not in_scope(relpath):
        return []
    v = _Visitor(relpath)
    v.visit(tree)
    return v.findings


def analyze_source(text: str, relpath: str) -> List[Finding]:
    return check_determinism(ast.parse(text), normalize_path(relpath))
