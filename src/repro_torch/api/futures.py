"""Asynchronous submission primitives for the context API.

The runtime is not re-entrant (one scheduling pass owns the devices),
so a context serializes submissions onto a single background worker —
the host-side analogue of enqueueing kernels on a stream: ``submit``
returns immediately, work proceeds in order, and the caller overlaps
its own work until it blocks on ``BlasFuture.result()``.

Two flow-control features matter to the serving layer
(``repro_torch.serve``): a ``max_pending`` bound on the executor
(callers either get :class:`BackpressureError` or opt into blocking
until a slot frees), and ``BlasFuture.cancel()`` for submissions that
have not started yet — the admission queue sheds load with both.
"""
from __future__ import annotations

import concurrent.futures
import threading
from typing import Any, Callable, Optional

CancelledError = concurrent.futures.CancelledError


class BackpressureError(RuntimeError):
    """Raised by ``SerialExecutor.submit`` when the pending-work bound
    (``max_pending``) is hit and the caller did not ask to block."""


class BlasFuture:
    """Handle to an in-flight L3 routine (cudaEvent/cudaStream flavour).

    Thin, deliberately minimal wrapper over
    :class:`concurrent.futures.Future`: ``result()`` blocks (and
    re-raises the routine's exception, if any), ``done()`` never
    blocks, ``exception()`` reports without raising, ``cancel()``
    withdraws a submission that has not started running.
    """

    def __init__(self, fut: "concurrent.futures.Future[Any]"):
        self._fut = fut

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until the routine finishes; returns its value (a
        ``MatrixHandle`` for the six L3 routines).  Raises
        :class:`concurrent.futures.CancelledError` if the submission
        was cancelled before it started."""
        return self._fut.result(timeout)

    def done(self) -> bool:
        """Non-blocking completion probe (True for cancelled too)."""
        return self._fut.done()

    def cancel(self) -> bool:
        """Withdraw the submission if it has not started running.
        Returns True on success; a running or finished routine cannot
        be cancelled (the runtime has no preemption) and returns
        False.  After a successful cancel, ``result()`` and
        ``exception()`` raise ``CancelledError``."""
        return self._fut.cancel()

    def cancelled(self) -> bool:
        return self._fut.cancelled()

    def exception(self, timeout: Optional[float] = None):
        """The routine's exception, or None if it succeeded.  Like the
        stdlib future, raises ``CancelledError`` when the submission
        was cancelled rather than run."""
        return self._fut.exception(timeout)

    def add_done_callback(self, fn: Callable[["BlasFuture"], None]) -> None:
        self._fut.add_done_callback(lambda _f: fn(self))

    def __repr__(self) -> str:
        if self.cancelled():
            state = "cancelled"
        else:
            state = "done" if self.done() else "pending"
        return f"BlasFuture({state})"


class _SlotBook:
    """The open flag and the pending-submission count of one
    :class:`SerialExecutor`, under one lock.

    A class of its own rather than fields of ``SerialExecutor`` because
    the reference's lock-order lint (``repro.analysis``) keys
    lock-owning classes by their bare name: a port class named
    ``SerialExecutor`` that declared a lock would take the place of the
    reference's executor in that graph.  Its methods are named so that
    the lint's by-name call resolution cannot confuse them with another
    class's.
    """

    _GUARDED_BY = {"_lock": ("_open", "_pending")}
    _LOCK_ALIASES = {"_slot_free": "_lock"}

    def __init__(self, max_pending: Optional[int]):
        self._lock = threading.Lock()
        self._slot_free = threading.Condition(self._lock)
        self._open = True
        self._pending = 0
        self.max_pending = max_pending

    def pending_count(self) -> int:
        with self._lock:
            return self._pending

    def claim_slot(self, block: bool, timeout: Optional[float]) -> None:
        """Count one more pending submission, waiting for a free slot
        when ``block``; raises when shut or at the bound."""
        with self._lock:
            if not self._open:
                raise RuntimeError("executor is shut down")
            if self.max_pending is not None:
                while self._pending >= self.max_pending:
                    if not block:
                        raise BackpressureError(
                            f"executor has {self._pending} pending "
                            f"submissions (max_pending={self.max_pending})")
                    if not self._slot_free.wait(timeout=timeout):
                        raise BackpressureError(
                            "timed out waiting for a pending slot "
                            f"(max_pending={self.max_pending})")
                    if not self._open:
                        raise RuntimeError("executor is shut down")
            self._pending += 1

    def free_slot(self) -> None:
        with self._lock:
            self._pending -= 1
            self._slot_free.notify()

    def close_slots(self) -> bool:
        """Refuse further claims and wake every waiter; True only for
        the call that closed the book."""
        with self._lock:
            if not self._open:
                return False
            self._open = False
            self._slot_free.notify_all()
            return True


class SerialExecutor:
    """One daemon worker draining submissions in FIFO order.

    ``max_pending`` bounds the number of not-yet-finished submissions
    (queued + running).  At the bound, ``submit`` raises
    :class:`BackpressureError` — or, with ``block=True``, waits until
    a slot frees (``block_timeout`` seconds, then the same error).
    ``max_pending=None`` keeps the unbounded behaviour.
    """

    def __init__(self, name: str = "blasx",
                 max_pending: Optional[int] = None):
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=name)
        self._slots = _SlotBook(max_pending)

    @property
    def pending(self) -> int:
        """Submissions not yet finished (queued + running)."""
        return self._slots.pending_count()

    def _on_done(self, _fut: "concurrent.futures.Future[Any]") -> None:
        # fires on completion, failure AND cancellation — every path
        # that retires a submission frees its slot
        self._slots.free_slot()

    def submit(self, fn: Callable[..., Any], *args,
               block: bool = False, block_timeout: Optional[float] = None,
               **kwargs) -> BlasFuture:
        """Enqueue ``fn(*args, **kwargs)`` on the worker.

        Keyword-only ``block``/``block_timeout`` are flow control for
        a bounded executor and are *not* forwarded to ``fn``.  A
        shutdown that lands between the slot claim and the enqueue
        makes the pool refuse the work (``RuntimeError``)."""
        self._slots.claim_slot(block, block_timeout)
        try:
            fut = self._pool.submit(fn, *args, **kwargs)
        except BaseException:
            self._slots.free_slot()
            raise
        # a fast task's done-callback can fire inline right here
        fut.add_done_callback(self._on_done)
        return BlasFuture(fut)

    def shutdown(self, wait: bool = True) -> None:
        if self._slots.close_slots():
            self._pool.shutdown(wait=wait)
