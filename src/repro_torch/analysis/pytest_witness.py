"""Pytest plugin: run the whole session under the lock-witness.

Usage (a threads-mode stress run)::

    python -m pytest -p repro_torch.analysis.pytest_witness \
        tests/test_torch_witness.py tests/test_torch_serve.py ...

The witness activates at configure time, before test modules import,
so module-level locks are wrapped too.  After each test the inversion
count is checked; the first test that introduces a dynamic lock-order
inversion errors in teardown with both acquisition stacks, so blame
lands on the test that interleaved the locks — not on session exit.
"""
from __future__ import annotations

from .witness import LockWitness

_witness = None
_active = None
_seen_inversions = 0


def pytest_configure(config):
    global _witness, _active
    _witness = LockWitness()
    _active = _witness.activate()
    _active.__enter__()


def pytest_runtest_teardown(item, nextitem):
    global _seen_inversions
    if _witness is None:
        return
    inv = _witness.inversions()
    if len(inv) > _seen_inversions:
        new = inv[_seen_inversions:]
        _seen_inversions = len(inv)
        detail = "\n".join(
            f"INVERSION:\n  {ab.describe()}\n  {ba.describe()}"
            for ab, ba in new)
        raise AssertionError(
            f"lock-witness: {len(new)} new lock-order inversion(s) "
            f"during {item.nodeid}:\n{detail}")


def pytest_unconfigure(config):
    global _active
    if _active is not None:
        _active.__exit__(None, None, None)
        _active = None


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    if _witness is not None:
        terminalreporter.write_line(_witness.report().splitlines()[0])
