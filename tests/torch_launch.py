"""The hand kernels' shared launch call on the CPU, for the ledger's tests.

``cpu_launch`` (a fixture) lets ``kernels.build.launch`` run without a
card: no device to enter, stream 0, a card of 132 SMs, and an empty
ledger of the test's own (the process's is put back after it).
``fake_entry(name, rc)`` stands for a bound entry point: it keeps the
arguments of each call in its ``calls`` and returns ``rc``.
"""
import contextlib
import types

import pytest
import torch

from repro_torch.kernels import build


@pytest.fixture
def cpu_launch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(build, "_sm_count", lambda index: 132)
    monkeypatch.setattr(build, "LAUNCHES", {})


def fake_entry(name: str, rc: int = 0):
    def entry(*args):
        entry.calls.append(args)
        return rc
    entry.__name__, entry.calls = name, []
    return entry
