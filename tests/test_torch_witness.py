"""The port's runtime lock-witness (``repro_torch.analysis.witness``).

Twins of ``test_witness.py``: a synthetic two-lock inversion across two
threads is reported with both acquisition stacks; a clean threads-mode
DGEMM on ``device="cpu"`` shows real edges, zero inversions and more
than zero witnessed port locks (a filter that matched nothing would
report a vacuous "0 inversions"); the pytest plugin runs as
``-p repro_torch.analysis.pytest_witness``; and the directory audit is
probed for the lock-order inversion the reference once had.
"""
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis.witness import LockWitness, _default_filter

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

REPO_ROOT = Path(__file__).resolve().parent.parent
SRC = REPO_ROOT / "src"


def test_synthetic_inversion_reported_with_both_stacks():
    w = LockWitness()
    with w.activate():
        lock_a = threading.Lock()
        lock_b = threading.Lock()

        def ab():
            with lock_a:
                with lock_b:
                    pass

        def ba():
            with lock_b:
                with lock_a:
                    pass

        # two threads, opposite order, serialized by join so the run
        # itself cannot deadlock — the witness records order, not luck
        t1 = threading.Thread(target=ab)
        t1.start()
        t1.join()
        t2 = threading.Thread(target=ba)
        t2.start()
        t2.join()

    inversions = w.inversions()
    assert len(inversions) == 1
    assert w.witnessed_locks == 2
    report = w.report()
    assert "INVERSION" in report
    # both acquisition stacks point back into this test
    assert report.count("test_torch_witness.py") >= 4
    assert "ab" in report and "ba" in report
    with pytest.raises(AssertionError, match="inversion"):
        w.assert_clean()


def test_nested_same_order_is_not_an_inversion():
    w = LockWitness()
    with w.activate():
        lock_a = threading.Lock()
        lock_b = threading.Lock()
        for _ in range(3):
            with lock_a:
                with lock_b:
                    pass
    assert w.inversions() == []
    assert w.edge_names() != []
    assert w.witnessed_locks == 2
    w.assert_clean()


def test_rlock_reentrancy_records_no_self_edge():
    w = LockWitness()
    with w.activate():
        lock = threading.RLock()
        with lock:
            with lock:
                pass
    assert w.edge_names() == []
    assert w.inversions() == []
    assert w.witnessed_locks == 1


def test_condition_wait_releases_witnessed_lock():
    """Condition(wrapped_lock) must go through the wrapper's
    _release_save/_acquire_restore: while the waiter is parked, the
    lock reads as free to the witness and to other threads."""
    w = LockWitness()
    with w.activate():
        lock = threading.Lock()
        cv = threading.Condition(lock)
        state = {"entered": False, "done": False}

        def waiter():
            with cv:
                state["entered"] = True
                cv.notify_all()
                while not state["done"]:
                    cv.wait(timeout=1.0)

        t = threading.Thread(target=waiter)
        t.start()
        with cv:
            while not state["entered"]:
                cv.wait(timeout=1.0)
            state["done"] = True
            cv.notify_all()
        t.join(timeout=5.0)
        assert not t.is_alive()
    # a single shared lock: no ordering edges, certainly no inversions
    assert w.inversions() == []
    assert w.witnessed_locks == 1


def test_witness_names_port_locks():
    w = LockWitness()
    with w.activate():
        from repro_torch.core.alru import Alru
        from repro_torch.core.heap import BlasxHeap
        alru = Alru(0, BlasxHeap(1 << 20))
        len(alru)  # first acquire happens inside a method -> named
    assert any(lk.name == "Alru._lock" for lk in w._locks.values())


def test_default_filter_wraps_port_and_tests_never_the_tracer():
    """The port's filter: its own source and the tests, never
    ``/analysis/`` (the reference's matched ``repro/`` alone, so no port
    lock was ever wrapped)."""
    assert _default_filter("/x/src/repro_torch/core/alru.py")
    assert _default_filter("/x/tests/test_torch_runtime.py")
    assert not _default_filter("/x/src/repro_torch/analysis/witness.py")
    assert not _default_filter("/usr/lib/python3.12/threading.py")
    from repro.analysis.witness import _default_filter as ref_filter
    assert not ref_filter("/x/src/repro_torch/core/alru.py")


def test_clean_threads_mode_dgemm_zero_inversions():
    """Acceptance: a real threads-mode multi-device DGEMM of the port on
    the host under the witness completes with real ordering edges, more
    than zero witnessed port locks and zero inversions; its result is
    the reference's threads-mode DGEMM's to 1e-10."""
    from repro.api.context import BlasxContext as RefContext
    from repro.core.runtime import RuntimeConfig as RefConfig

    rng = np.random.default_rng(7)
    a = rng.standard_normal((160, 160))
    b = rng.standard_normal((160, 160))
    w = LockWitness()
    with w.activate():
        from repro_torch.api.context import BlasxContext
        from repro_torch.core.runtime import RuntimeConfig

        with BlasxContext(RuntimeConfig(n_devices=2, mode="threads",
                                        device="cpu"), tile=64) as ctx:
            out = ctx.gemm(a, b).array()
    with RefContext(RefConfig(n_devices=2, mode="threads"), tile=64) as rc:
        want = rc.gemm(a, b).array()
    np.testing.assert_allclose(out, a @ b, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(out, want, rtol=1e-10, atol=1e-10)
    assert w.acquisitions > 0
    assert w.witnessed_locks > 0
    port_sites = [lk.site for lk in w._locks.values()]
    assert any(s.startswith(("alru.py", "taskqueue.py", "coherence.py"))
               for s in port_sites), port_sites
    assert w.edge_names() != []      # the runtime really interleaves
    assert w.inversions() == []
    w.assert_clean()


def test_pytest_plugin_fails_inverting_test_and_passes_clean(tmp_path):
    """The stress run's plugin: a test that interleaves two locks in
    opposite orders errors with the inversion report; a clean file
    passes with the witness summary printed."""
    bad = tmp_path / "test_inv.py"
    bad.write_text(
        "import threading\n\n\n"
        "def test_inverts():\n"
        "    a, b = threading.Lock(), threading.Lock()\n"
        "    with a:\n"
        "        with b:\n"
        "            pass\n"
        "    with b:\n"
        "        with a:\n"
        "            pass\n",
        encoding="utf-8")
    good = tmp_path / "test_ok.py"
    good.write_text(
        "import threading\n\n\n"
        "def test_ordered():\n"
        "    a, b = threading.Lock(), threading.Lock()\n"
        "    with a:\n"
        "        with b:\n"
        "            pass\n",
        encoding="utf-8")

    def run(target):
        return subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p",
             "repro_torch.analysis.pytest_witness", "-p",
             "no:cacheprovider", str(target)],
            capture_output=True, text=True, cwd=str(tmp_path),
            env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})

    proc = run(bad)
    assert proc.returncode != 0
    assert "lock-order inversion" in proc.stdout
    assert "test_inv.py" in proc.stdout   # both stacks shown

    proc = run(good)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lock-witness:" in proc.stdout
    assert "2 witnessed locks" in proc.stdout


# ---------------------------------------------------------------------------
# the reference's audit once queried ALRUs while holding the directory
# lock — the reverse of the eviction path's order.  The probe fails on
# that shape; the port's audit must stay snapshot-first.
# ---------------------------------------------------------------------------

class _ProbeAlru:
    """Quacks like an Alru for audit(); every query asserts the
    directory lock is NOT held by the querying thread."""

    def __init__(self, directory, keys):
        self._dir = directory
        self._keys = set(keys)

    def _assert_unlocked(self):
        assert not self._dir._lock._is_owned(), (
            "audit holds the directory lock while querying an ALRU — "
            "the Alru<->MesixDirectory lock-order inversion")

    def __contains__(self, key):
        self._assert_unlocked()
        return key in self._keys

    def keys(self):
        self._assert_unlocked()
        return list(self._keys)


def test_audit_queries_alrus_outside_directory_lock():
    from repro_torch.core.coherence import MesixDirectory
    from repro_torch.core.tiling import TileKey

    d = MesixDirectory(2, [[0, 1]])
    k1 = TileKey("A", 0, 0)
    k2 = TileKey("A", 0, 1)
    d.on_fill(k1, 0)
    d.on_fill(k2, 1)
    alrus = [_ProbeAlru(d, [k1]), _ProbeAlru(d, [k2])]
    d.audit(alrus)

    # the cross-check itself still bites in both directions
    with pytest.raises(RuntimeError, match="no such block"):
        d.audit([_ProbeAlru(d, []), _ProbeAlru(d, [k2])])
    with pytest.raises(RuntimeError, match="not list"):
        d.audit([_ProbeAlru(d, [k1, k2]), _ProbeAlru(d, [k2])])
