"""Global task queue + reservation stations (paper §IV-C, Fig. 4).

The paper uses the Michael–Scott non-blocking MPMC queue; under the
Python GIL, lock-freedom is moot, so we reproduce the *semantics* — a
shared global FIFO supporting concurrent dequeue (work sharing) — with
a lock-guarded deque plus a condition variable so threaded workers can
wait for TRSM dependencies to resolve.

The ReadyQueue is dependency aware: tasks with unmet ``deps`` are held
in a pending table and enqueued the moment their last producer
completes (the paper's TRSM intra-column chains).
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence

from .task import Task


class ReadyQueue:
    # lock-discipline declarations (repro.analysis, docs/ANALYSIS.md):
    # _cv wraps _lock, so `with self._cv` counts as holding _lock.
    _GUARDED_BY = {"_lock": (
        "_tasks", "_ready", "_pending_deps", "_dependents",
        "_outstanding")}
    _LOCK_ALIASES = {"_cv": "_lock"}

    def __init__(self, tasks: Sequence[Task]):
        self._tasks: Dict[int, Task] = {t.task_id: t for t in tasks}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._ready: collections.deque = collections.deque()
        self._pending_deps: Dict[int, int] = {}
        self._dependents: Dict[int, List[int]] = collections.defaultdict(list)
        self._outstanding = len(tasks)  # dequeued-but-not-completed + queued + pending
        for t in tasks:
            missing = len(t.deps)
            if missing == 0:
                self._ready.append(t.task_id)
            else:
                self._pending_deps[t.task_id] = missing
                for d in t.deps:
                    self._dependents[d].append(t.task_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ready)

    def try_dequeue(self) -> Optional[Task]:
        """Non-blocking dequeue (sim mode / RS refill)."""
        with self._lock:
            if self._ready:
                return self._tasks[self._ready.popleft()]
            return None

    def dequeue_wait(self, timeout: float = 0.05) -> Optional[Task]:
        """Blocking dequeue for threaded workers: returns a task, or None
        when the queue is *drained* (all tasks completed).  A None with
        tasks still outstanding means "retry" (spurious wakeup)."""
        with self._cv:
            while not self._ready and self._outstanding > 0:
                self._cv.wait(timeout=timeout)
                if not self._ready and self._outstanding > 0:
                    return None  # let the caller try stealing instead
            if self._ready:
                return self._tasks[self._ready.popleft()]
            return None

    def complete(self, task: Task) -> None:
        """Mark a task done; release dependents whose deps are all met.

        Safe to call with a *foreign* task (one owned by another queue in
        a static split): only its dependency edges are resolved here."""
        with self._cv:
            if task.task_id in self._tasks:
                self._outstanding -= 1
            for dep_id in self._dependents.pop(task.task_id, ()):
                left = self._pending_deps[dep_id] - 1
                if left == 0:
                    del self._pending_deps[dep_id]
                    self._ready.append(dep_id)
                else:
                    self._pending_deps[dep_id] = left
            self._cv.notify_all()

    def requeue(self, task: Task) -> None:
        """Return a dequeued-but-never-completed task to the ready end
        (worker crash recovery: reservation stations are drained back
        here so no task is stranded).  The task was already counted in
        ``_outstanding`` when dequeued, so only the ready list moves."""
        with self._cv:
            if task.task_id not in self._tasks:
                raise ValueError(f"requeue of foreign task {task.task_id}")
            self._ready.append(task.task_id)
            self._cv.notify_all()

    def drained(self) -> bool:
        with self._lock:
            return self._outstanding == 0

    def has_ready(self) -> bool:
        with self._lock:
            return bool(self._ready)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending_deps)


class ReservationStation:
    """Per-device task buffer (paper Fig. 4).  Each slot carries
    (priority, task); work stealing and priority scheduling act on it."""

    # lock-discipline declarations (repro.analysis, docs/ANALYSIS.md)
    _GUARDED_BY = {"_lock": ("_slots", "_prio")}

    def __init__(self, device_id: int, n_slots: int):
        self.device_id = device_id
        self.n_slots = n_slots
        self._slots: List[Task] = []
        self._prio: Dict[int, float] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    def free_slots(self) -> int:
        with self._lock:
            return self.n_slots - len(self._slots)

    def put(self, task: Task, priority: float) -> None:
        with self._lock:
            if len(self._slots) >= self.n_slots:
                raise RuntimeError("RS overflow")
            self._slots.append(task)
            self._prio[task.task_id] = priority

    def set_priorities(self, prio_fn) -> None:
        """Refresh priorities (paper: 'runtime refreshes the priorities in
        RS after new tasks coming in')."""
        with self._lock:
            for t in self._slots:
                self._prio[t.task_id] = prio_fn(t)

    def take_top(self, n: int) -> List[Task]:
        """Pop the top-n prioritized tasks (Alg. 1 line 19)."""
        with self._lock:
            self._slots.sort(key=lambda t: self._prio[t.task_id], reverse=True)
            taken = self._slots[:n]
            self._slots = self._slots[n:]
            for t in taken:
                self._prio.pop(t.task_id, None)
            return taken

    def drain(self) -> List[Task]:
        """Remove and return every buffered task (crash recovery)."""
        with self._lock:
            taken, self._slots = self._slots, []
            self._prio.clear()
            return taken

    def steal(self, prio_fn=None) -> Optional[Task]:
        """A peer steals the *lowest*-priority task — the one with the
        least locality value to this station's device.

        ``prio_fn`` re-evaluates each buffered task's priority (Eq. 3)
        against the device's *current* L1/L2 cache state before the
        victim is chosen.  Put-time priorities go stale as caches fill
        (``_fill_and_take`` only refreshes the thief's own station), so
        selecting on them could hand the thief a task whose input tiles
        are by now L1-hot here — the exact traffic stealing is meant to
        avoid.  Without ``prio_fn`` the stored priorities are used
        (FIFO-priority policies, unit tests)."""
        with self._lock:
            if not self._slots:
                return None
            if prio_fn is not None:
                for t in self._slots:
                    self._prio[t.task_id] = prio_fn(t)
            self._slots.sort(key=lambda t: self._prio[t.task_id], reverse=True)
            victim = self._slots.pop()
            self._prio.pop(victim.task_id, None)
            return victim
