"""The port's static analyses (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

Twins of ``test_analysis.py``: every rule fixture goes through both
analyzers, keyed under each package's own tree (``repro/<...>`` for the
reference, ``repro_torch/<...>`` for the port), and both must report
the same rules on the same lines with the same qualnames and details.
The gate twin runs over ``src/repro_torch`` against the port's own
baseline.  The port's additions are tested beside them: determinism is
scoped to ``repro_torch/core/`` and ``repro_torch/tuning/`` (the
reference's scope never reached a port file), DT002 also catches torch's
global generator, and importing the package loads neither torch nor
the reference.
"""
import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import RULES as REF_RULES
from repro.analysis import Baseline as RefBaseline
from repro.analysis import assertions as ref_as
from repro.analysis import determinism as ref_dt
from repro.analysis import locks as ref_ld
from repro.analysis import run_analyses as ref_run_analyses
from repro.analysis.findings import split_findings as ref_split
from repro_torch.analysis import RULES, Baseline, run_analyses
from repro_torch.analysis import assertions as as_mod
from repro_torch.analysis import determinism as dt_mod
from repro_torch.analysis import locks as ld_mod
from repro_torch.analysis.findings import (DEFAULT_BASELINE, Finding,
                                           normalize_path, split_findings)

REPO_ROOT = Path(__file__).resolve().parent.parent
SRC = REPO_ROOT / "src"
PORT = SRC / "repro_torch"


def _rules(findings):
    return sorted(f.rule for f in findings)


def _shape(findings):
    return sorted((f.rule, f.line, f.qualname, f.detail) for f in findings)


def _twin(port_mod, ref_mod, src, sub):
    """Run one fixture through both analyzers (keyed under each
    package's own tree); they must agree finding for finding.  Returns
    the port's findings."""
    text = textwrap.dedent(src)
    port = port_mod.analyze_source(text, f"repro_torch/{sub}")
    ref = ref_mod.analyze_source(text, f"repro/{sub}")
    assert _shape(port) == _shape(ref)
    assert [f.key for f in port] == [
        "repro_torch/" + f.key[len("repro/"):] for f in ref]
    return port


def ld(src, sub="core/fixture.py"):
    return _twin(ld_mod, ref_ld, src, sub)


def dt(src, sub):
    return _twin(dt_mod, ref_dt, src, sub)


def as_(src, sub="core/fixture.py"):
    return _twin(as_mod, ref_as, src, sub)


# ---------------------------------------------------------------------------
# rule catalog
# ---------------------------------------------------------------------------

def test_rule_catalog():
    assert set(RULES) == {"LD001", "LD002", "LD003", "LO001",
                          "DT001", "DT002", "AS001", "AS002"}
    assert set(RULES) == set(REF_RULES)


# ---------------------------------------------------------------------------
# LD001: guarded-field access without the lock
# ---------------------------------------------------------------------------

BAD_LD001 = """
    import threading

    class Ledger:
        _GUARDED_BY = {"_lock": ("served", "_depth")}

        def __init__(self):
            self._lock = threading.Lock()
            self.served = 0
            self._depth = 0

        def record(self, secs):
            self.served += secs      # racing += outside the lock

        def depth(self):
            with self._lock:
                return self._depth
"""


def test_ld001_detects_unguarded_access():
    findings = ld(BAD_LD001)
    assert [f.rule for f in findings] == ["LD001"]
    f = findings[0]
    assert f.qualname == "Ledger.record"
    assert f.detail == "served"
    assert f.key == "repro_torch/core/fixture.py::Ledger.record::served"


def test_ld001_clean_when_locked():
    fixed = BAD_LD001.replace(
        "self.served += secs      # racing += outside the lock",
        "with self._lock:\n                self.served += secs")
    assert ld(fixed) == []


def test_ld001_init_exempt_and_locked_suffix_exempt():
    src = """
    import threading

    class Box:
        _GUARDED_BY = {"_lock": ("items",)}

        def __init__(self):
            self._lock = threading.Lock()
            self.items = []

        def _append_locked(self, x):
            self.items.append(x)

        def append(self, x):
            with self._lock:
                self._append_locked(x)
    """
    assert ld(src) == []


def test_ld001_condition_alias_counts_as_lock():
    src = """
    import threading

    class Q:
        _GUARDED_BY = {"_lock": ("_items",)}
        _LOCK_ALIASES = {"_cv": "_lock"}

        def __init__(self):
            self._lock = threading.Lock()
            self._cv = threading.Condition(self._lock)
            self._items = []

        def put(self, x):
            with self._cv:
                self._items.append(x)
                self._cv.notify()
    """
    assert ld(src) == []


# ---------------------------------------------------------------------------
# LD002: blocking under a held lock — the inline-callback deadlock
# ---------------------------------------------------------------------------

INLINE_CALLBACK_DEADLOCK = """
    import threading

    class SerialExecutor:
        _GUARDED_BY = {"_lock": ("_open", "_pending")}
        _LOCK_ALIASES = {"_slot_free": "_lock"}

        def __init__(self, pool):
            self._pool = pool
            self._lock = threading.Lock()
            self._slot_free = threading.Condition(self._lock)
            self._open = True
            self._pending = 0

        def _on_done(self, fut):
            with self._lock:
                self._pending -= 1
                self._slot_free.notify()

        def submit(self, fn):
            with self._lock:
                self._pending += 1
                fut = self._pool.submit(fn)
                fut.add_done_callback(self._on_done)   # inline callback
            return fut
"""


def test_ld002_detects_inline_callback_deadlock():
    findings = [f for f in ld(INLINE_CALLBACK_DEADLOCK, "api/fixture.py")
                if f.rule == "LD002"]
    assert len(findings) == 1
    f = findings[0]
    assert f.qualname == "SerialExecutor.submit"
    assert f.detail == "add_done_callback"


def test_real_serial_executor_keeps_callback_outside_lock():
    """The port's executor (its lock lives in ``_SlotBook``) must stay
    LD002-clean under both analyzers, while the reintroduced shape
    (fixture above) is caught."""
    text = (PORT / "api/futures.py").read_text(encoding="utf-8")
    for mod, rel in ((ld_mod, "repro_torch/api/futures.py"),
                     (ref_ld, "repro/api/futures.py")):
        bad = [f for f in mod.analyze_source(text, rel) if f.rule == "LD002"]
        assert bad == [], [f.render() for f in bad]


def test_ld002_user_callback_and_sleep_and_result():
    src = """
    import threading, time

    class Cache:
        _GUARDED_BY = {"_lock": ("_map",)}
        _CALLBACKS = ("on_evict",)

        def __init__(self):
            self._lock = threading.Lock()
            self._map = {}
            self.on_evict = None

        def evict(self, k):
            with self._lock:
                del self._map[k]
                self.on_evict(k)

        def flush(self, fut):
            with self._lock:
                time.sleep(0.1)
                fut.result()
    """
    details = sorted(f.detail for f in ld(src) if f.rule == "LD002")
    assert details == ["on_evict", "result", "time.sleep"]


def test_ld002_wait_on_own_condition_ok_foreign_wait_flagged():
    src = """
    import threading

    class Q:
        _GUARDED_BY = {"_lock": ("_n",)}
        _LOCK_ALIASES = {"_cv": "_lock"}

        def __init__(self, other):
            self._lock = threading.Lock()
            self._cv = threading.Condition(self._lock)
            self._other = other
            self._n = 0

        def take(self):
            with self._cv:
                while self._n == 0:
                    self._cv.wait()      # fine: releases _lock
                self._n -= 1

        def bad(self):
            with self._lock:
                self._other.wait()       # blocks with _lock held
    """
    flagged = [f for f in ld(src) if f.rule == "LD002"]
    assert [f.qualname for f in flagged] == ["Q.bad"]


def test_ld002_string_join_not_flagged():
    src = """
    import threading

    class R:
        _GUARDED_BY = {"_lock": ("names",)}

        def __init__(self):
            self._lock = threading.Lock()
            self.names = []

        def render(self):
            with self._lock:
                return ", ".join(self.names)
    """
    assert ld(src) == []


def test_ld002_yield_under_lock():
    src = """
    import threading

    class Scope:
        _GUARDED_BY = {"_lock": ("depth",)}

        def __init__(self):
            self._lock = threading.Lock()
            self.depth = 0

        def scope(self):
            with self._lock:
                self.depth += 1
                yield self
                self.depth -= 1
    """
    flagged = [f for f in ld(src) if f.rule == "LD002"]
    assert [f.detail for f in flagged] == ["yield"]


# ---------------------------------------------------------------------------
# LD003: undeclared locks
# ---------------------------------------------------------------------------

def test_ld003_undeclared_lock():
    src = """
    import threading

    class Quiet:
        def __init__(self):
            self.serve_lock = threading.Lock()
    """
    findings = ld(src)
    assert _rules(findings) == ["LD003"]
    assert findings[0].detail == "serve_lock"


def test_ld003_silent_for_declared_class():
    src = """
    import threading

    class Loud:
        _GUARDED_BY = {"_lock": ("x",)}

        def __init__(self):
            self._lock = threading.Lock()
            self.x = 0
    """
    assert ld(src) == []


def test_every_port_lock_owner_declares_guarded_by():
    """Coverage itself: no class of the port allocates an instance lock
    without ``_GUARDED_BY`` (the reference baselines one such lock,
    ``DeviceSim.serve_lock``; the port keeps that counter in
    ``ServeMeter``, which declares its guard)."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(encoding="utf-8"))
        found += ld_mod.check_lock_discipline(tree, normalize_path(path))
    assert [f.render() for f in found if f.rule == "LD003"] == []
    # nor does any declared class break its own declaration
    assert [f.render() for f in found] == []


# ---------------------------------------------------------------------------
# LO001: lock-order cycles — the audit shape (a directory querying the
# ALRUs under its own lock while ALRU eviction calls back into the
# directory under the cache lock)
# ---------------------------------------------------------------------------

AUDIT_CYCLE = """
    import threading

    class Cache:
        _GUARDED_BY = {"_lock": ("_map",)}
        _LOCK_HELD = ("_dequeue",)
        _CALLBACKS = ("on_evict",)

        def __init__(self):
            self._lock = threading.RLock()
            self._map = {}
            self.on_evict = None

        def _dequeue(self, k):
            del self._map[k]
            self.on_evict(k)           # cache lock -> directory lock

        def __contains__(self, k):
            with self._lock:
                return k in self._map

    class Directory:
        _GUARDED_BY = {"_lock": ("_holders",)}

        def __init__(self):
            self._lock = threading.RLock()
            self._holders = {}

        def on_evict(self, k):
            with self._lock:
                self._holders.pop(k, None)

        def audit(self, caches):
            with self._lock:
                for k in self._holders:
                    if k not in caches[0]:   # directory lock -> cache lock
                        raise RuntimeError(k)
"""


def test_lo001_detects_audit_cycle():
    findings = [f for f in ld(AUDIT_CYCLE) if f.rule == "LO001"]
    assert len(findings) == 1
    f = findings[0]
    assert f.detail == "cycle:Cache<->Directory"
    assert "on_evict" in f.message and "__contains__" in f.message


def test_lo001_clean_after_snapshot_fix():
    fixed = AUDIT_CYCLE.replace(
        """\
        def audit(self, caches):
            with self._lock:
                for k in self._holders:
                    if k not in caches[0]:   # directory lock -> cache lock
                        raise RuntimeError(k)
""",
        """\
        def audit(self, caches):
            with self._lock:
                snap = list(self._holders)
            for k in snap:
                if k not in caches[0]:
                    raise RuntimeError(k)
""")
    assert fixed != AUDIT_CYCLE
    assert [f for f in ld(fixed) if f.rule == "LO001"] == []


def test_lo001_real_coherence_alru_pair_is_acyclic():
    """The port's audit takes a snapshot under the lock and queries the
    ALRUs outside it — the real pair must stay cycle-free under both
    analyzers."""
    for mod, pkg in ((ld_mod, "repro_torch"), (ref_ld, "repro")):
        mods = [(ast.parse((PORT / rel).read_text(encoding="utf-8")),
                 f"{pkg}/{rel}")
                for rel in ("core/alru.py", "core/coherence.py")]
        assert mod.check_lock_order(mods) == []


# ---------------------------------------------------------------------------
# DT001/DT002: determinism in virtual-clock paths
# ---------------------------------------------------------------------------

def test_dt001_wall_clock_in_core():
    src = """
    import time

    def span():
        t0 = time.perf_counter()
        return time.time() - t0
    """
    findings = dt(src, "core/fake_events.py")
    assert _rules(findings) == ["DT001", "DT001"]
    assert sorted(f.detail for f in findings) == \
        ["time.perf_counter", "time.time"]


def test_dt001_clock_reference_without_call_detected():
    findings = dt("import time\nCLOCK = time.perf_counter\n",
                  "tuning/fake.py")
    assert _rules(findings) == ["DT001"]
    assert findings[0].qualname == "<module>"


def test_dt001_out_of_scope_paths_exempt():
    src = "import time\n\ndef t():\n    return time.time()\n"
    assert dt(src, "launch/fake.py") == []
    assert dt(src, "serve/fake.py") == []


def test_dt002_ambient_rng_flagged_seeded_generator_ok():
    src = """
    import random
    import numpy as np

    def jitter():
        rng = np.random.default_rng(0)   # fine: explicit seed
        return random.random() + np.random.rand()
    """
    findings = dt(src, "tuning/fake.py")
    assert _rules(findings) == ["DT002", "DT002"]
    assert sorted(f.detail for f in findings) == \
        ["np.random.rand", "random.random"]


def test_dt001_port_core_fixture_flagged_by_port_missed_by_reference():
    """The gap this package closes: a wall-clock read in the port's
    ``core/`` is in the port's DT001 scope, while the reference scopes
    DT001 to ``repro/core/`` and keys a port file by its last two path
    parts, so it never sees one."""
    src = "import time\n\ndef stamp():\n    return time.perf_counter()\n"
    rel = "src/repro_torch/core/runtime_fixture.py"
    port = dt_mod.analyze_source(src, rel)
    assert [(f.rule, f.line, f.path) for f in port] == [
        ("DT001", 4, "repro_torch/core/runtime_fixture.py")]
    assert ref_dt.analyze_source(src, rel) == []


def test_dt002_torch_global_generator_flagged_explicit_generator_ok():
    """DT002's PyTorch form: torch's global generator is the ambient
    RNG the reference's numpy rule catches (JAX has none, so the
    reference never needed it)."""
    src = textwrap.dedent("""
    import torch

    def noise(seed):
        gen = torch.Generator().manual_seed(seed)     # fine: explicit
        ok = torch.randn(3, generator=gen) + torch.rand(3, generator=gen)
        torch.manual_seed(seed)                        # reseeds the global
        bad = torch.randn(3) + torch.randint(0, 9, (3,))
        draw = torch.multinomial
        return ok, bad, draw, torch.seed()
    """)
    findings = dt_mod.analyze_source(src, "repro_torch/core/fake.py")
    assert _rules(findings) == ["DT002"] * 5
    assert [(f.line, f.detail) for f in findings] == [
        (7, "torch.manual_seed"), (8, "torch.randn"), (8, "torch.randint"),
        (9, "torch.multinomial"), (10, "torch.seed")]
    # out of scope, and invisible to the reference's numpy-only rule
    assert dt_mod.analyze_source(src, "repro_torch/models/fake.py") == []
    assert ref_dt.analyze_source(src, "repro/core/fake.py") == []


# ---------------------------------------------------------------------------
# AS001/AS002: tautological invariant checks — the self-checking heap
# ---------------------------------------------------------------------------

HEAP_TAUTOLOGY = """
    class Heap:
        def check_invariants(self):
            walked = sum(1 for _ in self._occupied)
            if sum(1 for _ in self._occupied) != len(self._occupied):
                raise RuntimeError("table mismatch")
            if walked != walked:
                raise RuntimeError("unreachable")
"""


def test_as_rules_detect_heap_tautology():
    findings = as_(HEAP_TAUTOLOGY)
    assert _rules(findings) == ["AS001", "AS002"]
    as002 = next(f for f in findings if f.rule == "AS002")
    assert as002.qualname == "Heap.check_invariants"
    assert "_occupied" in as002.detail


def test_as_rules_scope_limited_to_check_functions():
    src = """
    def helper(x):
        return x == x      # silly, but not an invariant check

    def validate_table(t):
        return t.n == t.n  # flagged: validate_* is in scope
    """
    findings = as_(src)
    assert _rules(findings) == ["AS001"]
    assert findings[0].qualname == "validate_table"


def test_as001_honest_comparison_not_flagged():
    src = """
    def check_invariants(table, walked):
        if sum(1 for _ in walked) != len(table):
            raise RuntimeError("mismatch")
    """
    assert as_(src) == []


# ---------------------------------------------------------------------------
# baseline + CLI plumbing
# ---------------------------------------------------------------------------

def test_baseline_requires_justification(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"schema": 1, "suppressions": [
        {"rule": "LD001", "key": "a.py::C.m::x", "justification": ""}]}))
    with pytest.raises(ValueError, match="justification"):
        Baseline.load(p)


def test_baseline_covers_and_unused():
    f = Finding("LD001", "a.py", 3, "C.m", "x", "msg")
    b = Baseline([
        {"rule": "LD001", "key": "a.py::C.m::x", "justification": "ok"},
        {"rule": "DT001", "key": "b.py::f::time.time",
         "justification": "stale"}])
    assert b.covers(f)
    unsup, sup = split_findings([f], b)
    assert unsup == [] and sup == [f]
    assert b.unused([f]) == [("DT001", "b.py::f::time.time")]


def test_normalize_path_is_checkout_independent():
    assert normalize_path("/home/x/repo/src/repro_torch/core/alru.py") == \
        "repro_torch/core/alru.py"
    assert normalize_path("src/repro_torch/serve/server.py") == \
        "repro_torch/serve/server.py"
    assert normalize_path("repro_torch/api/futures.py") == \
        "repro_torch/api/futures.py"
    # the port's baseline lives beside its analyses, not the reference's
    assert DEFAULT_BASELINE == PORT / "analysis" / "baseline.json"


def _run_cli(*args, cwd=None):
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=str(cwd or REPO_ROOT),
        env=env)


def test_cli_strict_fails_on_finding_and_respects_baseline(tmp_path):
    bad = tmp_path / "mod.py"
    bad.write_text(textwrap.dedent("""
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
    """), encoding="utf-8")
    proc = _run_cli("--strict", str(bad))
    assert proc.returncode == 1
    assert "LD003" in proc.stdout

    key = f"{tmp_path.name}/mod.py::C::_lock"
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"schema": 1, "suppressions": [
        {"rule": "LD003", "key": key,
         "justification": "fixture lock, single-threaded"}]}))
    proc = _run_cli("--strict", "--baseline", str(base), str(bad))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "1 suppressed" in proc.stdout


def test_cli_json_and_list_rules(tmp_path):
    bad = tmp_path / "mod.py"
    bad.write_text("import threading\n\n\nclass C:\n"
                   "    def __init__(self):\n"
                   "        self._lock = threading.Lock()\n",
                   encoding="utf-8")
    proc = _run_cli("--json", str(bad))
    data = json.loads(proc.stdout)
    assert data["files"] == 1
    assert [f["rule"] for f in data["findings"]] == ["LD003"]

    proc = _run_cli("--list-rules")
    assert proc.returncode == 0
    for rule in RULES:
        assert rule in proc.stdout


def test_cli_default_gate_scans_the_port():
    """``python -m repro_torch.analysis --strict`` with no path scans
    ``src/repro_torch`` from the repo root and passes."""
    proc = _run_cli("--strict")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_files = len(list(PORT.rglob("*.py")))
    assert f"repro_torch.analysis: {n_files} files, 0 findings" in \
        proc.stdout


def test_cli_witness_smoke_on_the_host():
    """The reference smoke's workload (GEMM, SYRK and TRSM on a
    2-device threads-mode context, then a 2-lane server) through the
    port with ``--device cpu``: 0 inversions over more than 0 witnessed
    port locks.  Without a card, the default device raises as the
    runtime does."""
    proc = _run_cli("--witness-smoke", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("lock-witness:") and line.endswith(
        " 0 inversions"), line
    witnessed = int(line.split(" witnessed locks")[0].rsplit(" ", 1)[1])
    assert witnessed > 0
    proc = _run_cli("--witness-smoke")
    assert proc.returncode != 0
    assert "needs a CUDA card" in proc.stderr


def test_import_loads_neither_torch_nor_the_reference():
    """Stdlib-only at import, like the reference's package: the gate
    runs without torch or numpy, and nothing of ``repro`` is loaded."""
    code = ("import sys, repro_torch.analysis\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'torch', 'numpy', 'repro'}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PYTHONPATH": str(SRC),
                                          "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# the gates themselves
# ---------------------------------------------------------------------------

def test_port_tree_is_clean_under_committed_baseline():
    findings, n_files = run_analyses([str(PORT)])
    unsup, sup = split_findings(findings, Baseline.load())
    assert n_files > 50
    assert unsup == [], "\n".join(f.render() for f in unsup)
    # the baseline documents real intentional patterns, not dead keys:
    # the threads worker's two wall-clock reads
    assert [(f.rule, f.qualname) for f in sup] == [
        ("DT001", "BlasxRuntime._run_threads.worker")] * 2
    assert Baseline.load().unused(findings) == []
    assert all(e for e in Baseline.load()._entries.values())


def test_reference_gate_sees_nothing_new_in_the_port():
    """The reference gate over all of ``src/`` (the port included, whose
    classes share its by-name lock graph) reads exactly what it reads
    over ``src/repro`` alone: no finding, the same suppressions."""
    whole, _ = ref_run_analyses([str(SRC)])
    alone, _ = ref_run_analyses([str(SRC / "repro")])
    base = RefBaseline.load()
    unsup, sup = ref_split(whole, base)
    assert unsup == [], "\n".join(f.render() for f in unsup)
    assert [f.key for f in sup] == [f.key for f in ref_split(alone, base)[1]]
    assert len(sup) == 6
