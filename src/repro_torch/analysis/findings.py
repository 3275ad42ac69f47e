"""Finding model + suppression baseline for ``repro_torch.analysis``.

Every analysis emits :class:`Finding` records carrying a rule id, a
repo-relative ``file:line`` anchor and a **stable suppression key**
(``path::qualname::detail``) that survives unrelated edits — line
numbers are for humans, keys are for the committed baseline.

The baseline (``src/repro_torch/analysis/baseline.json``) is the list of
*intentional* patterns: each entry names the rule, the key and a
one-line justification (review policy: a new suppression needs the
justification to say why the pattern is safe, not just that it is
old).  ``python -m repro_torch.analysis --strict`` fails on any finding
not covered by the baseline — new violations break the gate,
grandfathered patterns stay green and documented.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

BASELINE_SCHEMA = 1
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"

# rule catalog: id -> one-line description (the same ids as the
# reference's catalog; test_torch_analysis cross-checks them)
RULES: Dict[str, str] = {
    "LD001": "guarded field accessed without holding its declared lock",
    "LD002": "blocking call / user callback / yield while a lock is held",
    "LD003": "class allocates a threading lock but declares no _GUARDED_BY",
    "LO001": "static lock-order cycle between lock-owning classes",
    "DT001": "wall-clock read (time.time/perf_counter/...) in a "
             "virtual-clock path",
    "DT002": "ambient RNG (random.*, np.random.*, torch's global "
             "generator) in a virtual-clock path",
    "AS001": "invariant check compares an expression to itself",
    "AS002": "invariant check counts an iterable against its own len()",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis result, anchored to ``path:line``.

    ``qualname`` is the enclosing ``Class.method`` (or ``<module>``);
    ``detail`` is the rule-specific stable token (field name, callee,
    clock function ...) that makes the suppression key edit-stable."""

    rule: str
    path: str
    line: int
    qualname: str
    detail: str
    message: str

    @property
    def key(self) -> str:
        return f"{self.path}::{self.qualname}::{self.detail}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} [{self.qualname}] " \
               f"{self.message}"


def normalize_path(path) -> str:
    """Repo-relative posix path starting at ``repro_torch/`` when the
    file lives under a ``src/`` layout — baseline keys must not depend
    on where the repo is checked out or which prefix the CLI was
    given."""
    p = Path(path).as_posix()
    for marker in ("/src/repro_torch/", "src/repro_torch/"):
        idx = p.find(marker)
        if idx >= 0:
            return "repro_torch/" + p[idx + len(marker):]
    if p.startswith("repro_torch/"):
        return p
    # keep the last two components so fixture files get stable keys
    parts = p.split("/")
    return "/".join(parts[-2:]) if len(parts) > 1 else p


class Baseline:
    """Committed suppression set: ``(rule, key) -> justification``."""

    def __init__(self, entries: Optional[Iterable[dict]] = None):
        self._entries: Dict[Tuple[str, str], str] = {}
        for e in entries or ():
            self._entries[(e["rule"], e["key"])] = e.get("justification", "")

    def __len__(self) -> int:
        return len(self._entries)

    def covers(self, f: Finding) -> bool:
        return (f.rule, f.key) in self._entries

    def unused(self, findings: Iterable[Finding]) -> List[Tuple[str, str]]:
        """Suppressions that matched nothing — stale entries worth
        pruning (reported as warnings, never failures)."""
        hit = {(f.rule, f.key) for f in findings}
        return sorted(k for k in self._entries if k not in hit)

    @classmethod
    def load(cls, path=None) -> "Baseline":
        p = Path(path) if path is not None else DEFAULT_BASELINE
        if not p.exists():
            return cls()
        data = json.loads(p.read_text(encoding="utf-8"))
        if data.get("schema") != BASELINE_SCHEMA:
            raise ValueError(
                f"baseline {p} has schema {data.get('schema')!r}, "
                f"expected {BASELINE_SCHEMA}")
        entries = data.get("suppressions", [])
        for e in entries:
            if not e.get("justification", "").strip():
                raise ValueError(
                    f"baseline entry {e.get('rule')}/{e.get('key')} has no "
                    "justification (review policy: every suppression says "
                    "why the pattern is safe)")
        return cls(entries)


def split_findings(findings: Iterable[Finding], baseline: Baseline
                   ) -> Tuple[List[Finding], List[Finding]]:
    """(unsuppressed, suppressed) partition, both sorted for stable
    output."""
    unsup, sup = [], []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        (sup if baseline.covers(f) else unsup).append(f)
    return unsup, sup
