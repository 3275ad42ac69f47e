"""The port's asynchronous submission, executor and batched GEMM.

Twins of the async, executor and batched tests of ``test_api.py``.
Where a routine runs, the same seeded numpy inputs go through a
reference context (numpy backend) and a port context on the CPU (the
``cuda`` and ``torch`` backends; the GEMM kernel's plain version runs),
and the results must agree at the reference's 1e-10 with equal per-call
ledgers.  The executor tests order their threads with events and
barriers, never with sleeps that race the worker.
"""
import concurrent.futures
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.api import BlasxContext as RefContext
from repro.core.runtime import RuntimeConfig as RefConfig
from repro_torch.api import (BackpressureError, BlasFuture, BlasxContext,
                             MatrixHandle, SerialExecutor)
from repro_torch.core.runtime import RuntimeConfig

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)
WAIT = 30            # seconds any wait in these tests may take at most


def _cfg(**kw):
    kw.setdefault("n_devices", 2)
    kw.setdefault("mode", "sim")
    kw.setdefault("cache_bytes", 64 << 20)
    return kw


def _contexts(backend="cuda", **kw):
    kw = _cfg(**kw)
    return (RefContext(RefConfig(**kw), tile=48),
            BlasxContext(RuntimeConfig(backend=backend, device="cpu", **kw),
                         tile=48))


def _ledger(ctx):
    return [dataclasses.asdict(c) for c in ctx.calls]


def _array(x):
    """A result as float64 numpy (a bf16 result is a CPU tensor)."""
    return torch.as_tensor(x).double().numpy()


# ================================================================ submit
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_submit_returns_future_with_result(backend):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((120, 120))
    B = rng.standard_normal((120, 120))
    ref_ctx, ctx = _contexts(backend)
    with ref_ctx, ctx:
        want = [ref_ctx.submit("gemm", A, B, alpha=0.5),
                ref_ctx.submit("syrk", A)]
        got = [ctx.submit("gemm", A, B, alpha=0.5), ctx.submit("syrk", A)]
        assert all(isinstance(f, BlasFuture) for f in got)
        outs = [f.result(timeout=WAIT) for f in got]
        assert all(f.done() and f.exception() is None for f in got)
        assert all(isinstance(o, MatrixHandle) for o in outs)
        for o, w in zip(outs, want):
            np.testing.assert_allclose(o.array(),
                                       w.result(timeout=WAIT).array(), **TOL)
        np.testing.assert_allclose(outs[0].array(), 0.5 * A @ B, **TOL)
        assert _ledger(ctx) == _ledger(ref_ctx)


def test_submit_error_futures_keep_the_worker_alive():
    """An error future carries the routine's exception; a bad routine
    name is refused at submit; the next submission still runs."""
    _, ctx = _contexts()
    with ctx:
        f = ctx.submit("gemm", np.zeros((3, 4)), np.zeros((5, 6)))
        with pytest.raises(ValueError, match="inner dims"):
            f.result(timeout=WAIT)
        assert isinstance(f.exception(), ValueError)
        with pytest.raises(ValueError, match="unknown routine"):
            ctx.submit("not_a_routine")
        A = np.eye(16)
        ok = ctx.submit("gemm", A, A).result(timeout=WAIT)
        np.testing.assert_allclose(ok.array(), A, **TOL)


def test_submitted_chain_runs_in_order_and_warm():
    """Chained submissions on one handle run in FIFO order, later ones
    from the warm cache, with the reference's per-call ledger."""
    A = np.random.default_rng(2).standard_normal((160, 160))
    ref_ctx, ctx = _contexts()
    with ref_ctx, ctx:
        for c in (ref_ctx, ctx):
            Ah = c.tile(A)
            futs = [c.submit("gemm", Ah, Ah) for _ in range(4)]
            for f in futs:
                np.testing.assert_allclose(f.result(timeout=WAIT).array(),
                                           A @ A, **TOL)
        assert ctx.calls[-1].h2d_bytes < ctx.calls[0].h2d_bytes
        assert _ledger(ctx) == _ledger(ref_ctx)


def test_submit_chain_feeds_earlier_results_forward():
    """Later submissions take the handles earlier futures return."""
    A = np.random.default_rng(3).standard_normal((96, 96)) / 10
    _, ctx = _contexts()
    with ctx:
        h = ctx.tile(A)
        for _ in range(3):
            h = ctx.submit("gemm", h, ctx.tile(A)).result(timeout=WAIT)
    np.testing.assert_allclose(h.array(), np.linalg.matrix_power(A, 4),
                               **TOL)


def test_ctx_submit_close_race_is_clean():
    """A submit during close raises cleanly, in-flight work completes,
    and the executor does not leak.  The closer is observed through
    the context's closed flag; the in-flight callable holds it open
    on an event."""
    gate, running = threading.Event(), threading.Event()
    _, ctx = _contexts()
    f = ctx.submit(lambda: (running.set(), gate.wait(WAIT)) and "done")
    assert running.wait(WAIT)
    closer = threading.Thread(target=ctx.close)
    closer.start()
    # close() flags the context before it drains the executor, so the
    # flag flips while the in-flight callable still waits on the gate
    deadline = time.monotonic() + WAIT
    while not ctx.closed and time.monotonic() < deadline:
        time.sleep(0.001)
    assert ctx.closed and closer.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        ctx.submit("gemm", np.eye(8), np.eye(8))
    gate.set()
    closer.join(timeout=WAIT)
    assert not closer.is_alive()
    assert f.result(timeout=WAIT) == "done"
    assert ctx._log.detach_executor() is None   # close took it


def test_ctx_submit_fifo_under_concurrent_submitters():
    """The single-lane executor keeps each submitter's order while
    four threads, released together by a barrier, race on submit."""
    order = []
    barrier = threading.Barrier(4)
    _, ctx = _contexts()
    with ctx:
        def submitter(tid):
            barrier.wait(WAIT)
            for i in range(8):
                ctx.submit(lambda t=tid, k=i: order.append((t, k)))

        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
        ctx.submit(lambda: None).result(timeout=WAIT)  # drain barrier
    assert len(order) == 32
    for tid in range(4):
        ks = [k for t, k in order if t == tid]
        assert ks == sorted(ks)


# ============================================================== executor
def _stall(ex):
    """Occupy the executor's worker until the returned gate is set."""
    gate, running = threading.Event(), threading.Event()
    f = ex.submit(lambda: (running.set(), gate.wait(WAIT)) and "ran")
    assert running.wait(WAIT)
    return gate, f


def test_serial_executor_backpressure_bound():
    ex = SerialExecutor(max_pending=1)
    try:
        gate, f1 = _stall(ex)
        with pytest.raises(BackpressureError, match="max_pending"):
            ex.submit(lambda: 2)
        assert ex.pending == 1
        gate.set()
        assert f1.result(timeout=WAIT) == "ran"
        # the slot frees on completion (the done-callback may still be
        # running when result() returns, so wait for the slot)
        assert ex.submit(lambda: 3, block=True,
                         block_timeout=WAIT).result(timeout=WAIT) == 3
        assert ex.pending <= 1
    finally:
        ex.shutdown()


def test_serial_executor_blocking_submit_waits_for_slot():
    """A blocking submit at the bound waits until the stalled task
    finishes: while the gate is shut no slot can free, so the submitter
    is still blocked whenever it is looked at; opening the gate lets
    it through."""
    ex = SerialExecutor(max_pending=1)
    try:
        gate, f1 = _stall(ex)
        result = {}
        t = threading.Thread(target=lambda: result.update(
            f=ex.submit(lambda: 42, block=True, block_timeout=WAIT)))
        t.start()
        t.join(timeout=0.05)
        assert t.is_alive() and "f" not in result
        gate.set()
        t.join(timeout=WAIT)
        assert not t.is_alive()
        assert result["f"].result(timeout=WAIT) == 42
        assert f1.result(timeout=WAIT) == "ran"
    finally:
        ex.shutdown()


def test_serial_executor_blocking_submit_times_out():
    """The stalled task never finishes inside the block timeout (its
    gate opens only afterwards), so the wait must give up."""
    ex = SerialExecutor(max_pending=1)
    try:
        gate, f1 = _stall(ex)
        with pytest.raises(BackpressureError, match="timed out"):
            ex.submit(lambda: 2, block=True, block_timeout=0.05)
        gate.set()
        assert f1.result(timeout=WAIT) == "ran"
    finally:
        ex.shutdown()


def test_serial_executor_unbounded_and_validation():
    ex = SerialExecutor()                   # max_pending=None
    gate = threading.Event()
    try:
        futs = [ex.submit(lambda: gate.wait(WAIT)) for _ in range(20)]
        assert ex.pending == 20
        gate.set()
        assert all(f.result(timeout=WAIT) for f in futs)
    finally:
        ex.shutdown()
    with pytest.raises(ValueError, match="max_pending"):
        SerialExecutor(max_pending=0)
    with pytest.raises(RuntimeError, match="shut down"):
        ex.submit(lambda: 1)
    ex.shutdown()                           # idempotent


def test_blasfuture_cancel_semantics():
    """A queued submission cancels; result()/exception() then raise
    CancelledError; a running one refuses to cancel."""
    ex = SerialExecutor()
    try:
        gate, f1 = _stall(ex)
        f2 = ex.submit(lambda: "never")
        assert not f1.cancel()              # already running
        assert f2.cancel()                  # still queued
        assert f2.cancelled() and f2.done()
        assert "cancelled" in repr(f2) and "pending" in repr(f1)
        with pytest.raises(concurrent.futures.CancelledError):
            f2.result(timeout=1)
        with pytest.raises(concurrent.futures.CancelledError):
            f2.exception(timeout=1)
        seen = []
        f1.add_done_callback(seen.append)
        gate.set()
        assert f1.result(timeout=WAIT) == "ran"
        assert not f1.cancelled() and seen == [f1]
        assert "done" in repr(f1)
    finally:
        ex.shutdown()


def test_cancelled_submission_frees_backpressure_slot():
    ex = SerialExecutor(max_pending=2)
    try:
        gate, f1 = _stall(ex)
        doomed = ex.submit(lambda: None)
        with pytest.raises(BackpressureError):
            ex.submit(lambda: None)
        assert doomed.cancel()
        f = ex.submit(lambda: "fits")       # cancel freed the slot
        gate.set()
        assert f.result(timeout=WAIT) == "fits"
        assert f1.result(timeout=WAIT) == "ran"
    finally:
        ex.shutdown()


def test_executor_pending_count_is_exact_under_racing_submitters():
    """Eight threads submit and complete 50 tasks each against a bound
    of 4 with blocking submits; every task runs once and the pending
    count returns to 0 (a lost update would leave it off)."""
    ex = SerialExecutor(max_pending=4)
    done = []
    barrier = threading.Barrier(8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def submitter(tid):
            barrier.wait(WAIT)
            futs = [ex.submit(done.append, (tid, i), block=True,
                              block_timeout=WAIT) for i in range(50)]
            for f in futs:
                f.result(timeout=WAIT)

        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        ex.shutdown()
    assert len(done) == 400 and len(set(done)) == 400
    assert ex.pending == 0


# =============================================================== batched
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_gemm_batched_shared_weight_handle(backend):
    rng = np.random.default_rng(4)
    W = rng.standard_normal((128, 96))
    xs = [rng.standard_normal((64, 128)) for _ in range(5)]
    ref_ctx, ctx = _contexts(backend, n_devices=1)
    with ref_ctx, ctx:
        want = ref_ctx.gemm_batched(xs, [ref_ctx.tile(W)] * len(xs))
        outs = ctx.gemm_batched(xs, [ctx.tile(W)] * len(xs))
        for o, w, x in zip(outs, want, xs):
            np.testing.assert_allclose(o.array(), x @ W, **TOL)
            np.testing.assert_allclose(o.array(), w.array(), **TOL)
        # W moved once, then served from the warm cache
        total_h2d = sum(c.h2d_bytes for c in ctx.calls)
        cold_would_be = sum(x.nbytes for x in xs) + len(xs) * W.nbytes
        assert total_h2d <= cold_would_be - (len(xs) - 1) * W.nbytes
        assert ctx.calls[1].h2d_bytes < ctx.calls[0].h2d_bytes
        assert _ledger(ctx) == _ledger(ref_ctx)


def test_gemm_batched_submittable_async():
    """Submitting the batch itself must not deadlock the single-worker
    executor (the batch loops synchronously inside)."""
    A = np.random.default_rng(5).standard_normal((64, 64))
    _, ctx = _contexts()
    with ctx:
        f = ctx.submit("gemm_batched", [A, A], [A, A])
        outs = f.result(timeout=WAIT)
        assert f.done() and len(outs) == 2
        for o in outs:
            np.testing.assert_allclose(o.array(), A @ A, **TOL)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_gemm_strided_batched_broadcasts_weights(dtype):
    """A 2-D weight broadcasts over a 3-D batch with its C; bf16 comes
    back as a CPU tensor (numpy has no bfloat16), the others as numpy,
    and f64 matches the reference's numpy backend."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 48, 64))
    W = rng.standard_normal((64, 32))
    C = rng.standard_normal((3, 48, 32))
    ref_ctx, ctx = _contexts()
    with ref_ctx, ctx:
        out = ctx.gemm_strided_batched(x, W, C, alpha=1.5, beta=0.5,
                                       dtype=dtype)
        if dtype == "float64":
            want = ref_ctx.gemm_strided_batched(x, W, C, alpha=1.5, beta=0.5)
            np.testing.assert_allclose(out, want, **TOL)
            assert _ledger(ctx) == _ledger(ref_ctx)
    assert tuple(out.shape) == (3, 48, 32)
    assert isinstance(out, torch.Tensor) == (dtype == "bfloat16")
    tol = {"float64": 1e-10, "float32": 2e-3, "bfloat16": 6e-2}[dtype]
    for i in range(3):
        want_i = 1.5 * x[i] @ W + 0.5 * C[i]
        err = np.linalg.norm(_array(out[i]) - want_i) / np.linalg.norm(want_i)
        assert err <= tol


def test_gemm_batched_validates_lengths_and_operands():
    _, ctx = _contexts()
    with ctx:
        with pytest.raises(ValueError, match="batch mismatch"):
            ctx.gemm_batched([np.eye(8)], [np.eye(8), np.eye(8)])
        with pytest.raises(ValueError, match="batch mismatch"):
            ctx.gemm_batched([np.eye(8)], [np.eye(8)], [np.eye(8)] * 2)
        with pytest.raises(ValueError, match="at least one operand"):
            ctx.gemm_strided_batched(np.eye(8), np.eye(8))
        with pytest.raises(ValueError, match="inconsistent batch"):
            ctx.gemm_strided_batched(np.zeros((2, 8, 8)), np.zeros((3, 8, 8)))
        with pytest.raises(ValueError, match="2-D or 3-D"):
            ctx.gemm_strided_batched(np.zeros((2, 2, 8, 8)), np.eye(8))
