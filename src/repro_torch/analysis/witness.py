"""Runtime lock-witness: dynamic lock-order recording for threads mode.

The static graph in :mod:`.locks` over-approximates by name; the
witness closes the loop from the other side.  Inside
``LockWitness.activate()`` the ``threading.Lock`` / ``threading.RLock``
factories are patched so that locks *allocated from the port's source
or test files* come back wrapped.  Each wrapper reports acquire/release
to the witness, which keeps a per-thread stack of held locks and a
directed edge ``A -> B`` whenever ``B`` is acquired while ``A`` is
held — with both acquisition stacks captured the first time the edge
is seen.  An edge pair ``A -> B`` and ``B -> A`` between the same two
lock *instances* is an inversion: two threads interleaving those
regions can deadlock.

Design notes:

* the caller-filename filter at allocation time keeps stdlib and
  third-party locks (ThreadPoolExecutor internals, logging, ...) out
  of the graph — ``threading.Condition()``'s internally-allocated
  RLock is born in ``threading.py`` and therefore unwrapped;
* wrappers implement ``_release_save`` / ``_acquire_restore`` /
  ``_is_owned`` so ``threading.Condition(wrapped_lock)`` works and
  ``cv.wait`` correctly pops the held stack while parked;
* reentrant acquisition of a lock already held by the thread records
  no edge (an RLock deadlocks with nobody over itself);
* witness bookkeeping is serialized by a lock from the *original*
  factory, so the witness never traces itself;
* lock names are inferred lazily on first acquire by walking a few
  caller frames for a ``self`` that owns the wrapper — yielding
  ``Alru._lock``-style names in reports.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import traceback
from typing import Dict, List, Optional, Tuple

_STACK_LIMIT = 12


def _default_filter(filename: str) -> bool:
    """Wrap locks allocated from the port's source or repo tests."""
    f = filename.replace("\\", "/")
    if "/analysis/" in f:
        return False  # never trace the tracer
    return ("repro_torch/" in f or "/tests/" in f
            or "test_" in f.rsplit("/", 1)[-1])


def _capture_stack(skip: int) -> "traceback.StackSummary":
    frame = sys._getframe(skip)
    return traceback.StackSummary.extract(
        traceback.walk_stack(frame), limit=_STACK_LIMIT,
        lookup_lines=False)


def _format_stack(stack) -> str:
    # walk_stack yields innermost-first; print outermost-first like a
    # normal traceback
    return "".join(reversed(stack.format()))


class _Held:
    """One entry on a thread's held-lock stack."""

    __slots__ = ("lock", "stack")

    def __init__(self, lock: "WitnessedLock", stack):
        self.lock = lock
        self.stack = stack


class _Edge:
    """First-seen evidence for lock A held while acquiring lock B."""

    __slots__ = ("held_name", "acq_name", "held_stack", "acq_stack",
                 "count")

    def __init__(self, held_name, acq_name, held_stack, acq_stack):
        self.held_name = held_name
        self.acq_name = acq_name
        self.held_stack = held_stack
        self.acq_stack = acq_stack
        self.count = 1

    def describe(self) -> str:
        return (
            f"{self.held_name} held while acquiring {self.acq_name} "
            f"(seen {self.count}x)\n"
            f"  -- {self.held_name} acquired at:\n"
            f"{_format_stack(self.held_stack)}"
            f"  -- {self.acq_name} acquired at:\n"
            f"{_format_stack(self.acq_stack)}")


class WitnessedLock:
    """Wrapper recording acquire/release; Condition-compatible."""

    def __init__(self, inner, witness: "LockWitness", site: str,
                 kind: str):
        self._inner = inner
        self._witness = witness
        self.site = site        # "file.py:lineno" of the allocation
        self.kind = kind        # "Lock" | "RLock"
        self.name: Optional[str] = None  # inferred on first acquire

    # -- plain lock protocol ----------------------------------------
    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._witness._note_acquire(self, skip=2)
        return got

    def release(self):
        self._witness._note_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # -- Condition(lock) protocol -----------------------------------
    def _release_save(self):
        self._witness._note_release(self)
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._witness._note_acquire(self, skip=2)

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain Lock heuristic, mirroring threading.Condition._is_owned
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        return f"<WitnessedLock {self.display_name} at {hex(id(self))}>"

    @property
    def display_name(self) -> str:
        return self.name or f"{self.kind}@{self.site}"


class LockWitness:
    """Records per-thread acquisition order; reports inversions."""

    def __init__(self, capture_stacks: bool = True):
        self.capture_stacks = capture_stacks
        self._boot_lock_factory = threading.Lock
        self._meta = self._boot_lock_factory()  # bookkeeping guard
        self._held: Dict[int, List[_Held]] = {}
        self._edges: Dict[Tuple[int, int], _Edge] = {}
        self._locks: Dict[int, "WitnessedLock"] = {}
        self.acquisitions = 0

    # -- factory patching -------------------------------------------
    @contextlib.contextmanager
    def activate(self, wrap_filter=_default_filter):
        """Patch threading.Lock/RLock so port-allocated locks are
        witnessed.  Locks created before activation are untouched."""
        orig_lock, orig_rlock = threading.Lock, threading.RLock

        def factory(orig, kind):
            def alloc():
                caller = sys._getframe(1)
                if not wrap_filter(caller.f_code.co_filename):
                    return orig()
                site = f"{caller.f_code.co_filename.rsplit('/', 1)[-1]}" \
                       f":{caller.f_lineno}"
                lock = WitnessedLock(orig(), self, site, kind)
                with self._meta:
                    self._locks[id(lock)] = lock
                return lock
            return alloc

        threading.Lock = factory(orig_lock, "Lock")
        threading.RLock = factory(orig_rlock, "RLock")
        try:
            yield self
        finally:
            threading.Lock = orig_lock
            threading.RLock = orig_rlock

    # -- acquire/release callbacks ----------------------------------
    def _note_acquire(self, lock: WitnessedLock, skip: int):
        if lock.name is None:
            lock.name = self._infer_name(lock, skip + 1)
        stack = _capture_stack(skip + 1) if self.capture_stacks else None
        tid = threading.get_ident()
        with self._meta:
            self.acquisitions += 1
            held = self._held.setdefault(tid, [])
            reentrant = any(h.lock is lock for h in held)
            if not reentrant:
                for h in held:
                    self._record_edge(h, lock, stack)
            held.append(_Held(lock, stack))

    def _note_release(self, lock: WitnessedLock):
        tid = threading.get_ident()
        with self._meta:
            held = self._held.get(tid, [])
            for i in range(len(held) - 1, -1, -1):
                if held[i].lock is lock:
                    del held[i]
                    break

    def _record_edge(self, held: _Held, acq: WitnessedLock, acq_stack):
        key = (id(held.lock), id(acq))
        edge = self._edges.get(key)
        if edge is not None:
            edge.count += 1
            return
        self._edges[key] = _Edge(
            held.lock.display_name, acq.display_name,
            held.stack if held.stack is not None
            else traceback.StackSummary.from_list([]),
            acq_stack if acq_stack is not None
            else traceback.StackSummary.from_list([]))

    def _infer_name(self, lock: WitnessedLock, skip: int) -> str:
        """``Owner._attr`` from the nearest caller frame whose ``self``
        holds this wrapper as an attribute."""
        try:
            frame = sys._getframe(skip)
        except ValueError:
            return lock.display_name
        for _ in range(6):
            if frame is None:
                break
            owner = frame.f_locals.get("self")
            if owner is not None and owner is not lock \
                    and not isinstance(owner, LockWitness):
                try:
                    attrs = vars(owner)
                except TypeError:
                    attrs = {}
                for attr_name, val in attrs.items():
                    if val is lock:
                        return f"{type(owner).__name__}.{attr_name}"
            frame = frame.f_back
        return f"{lock.kind}@{lock.site}"

    # -- reporting ---------------------------------------------------
    @property
    def witnessed_locks(self) -> int:
        """Locks wrapped so far.  0 after a workload means the filter
        matched nothing, and "0 inversions" then proves nothing."""
        with self._meta:
            return len(self._locks)

    def inversions(self) -> List[Tuple[_Edge, _Edge]]:
        """Pairs of opposed edges between the same two lock instances."""
        with self._meta:
            out = []
            for (a, b), ab in sorted(self._edges.items()):
                if a < b:
                    ba = self._edges.get((b, a))
                    if ba is not None:
                        out.append((ab, ba))
            return out

    def edge_names(self) -> List[Tuple[str, str]]:
        with self._meta:
            return sorted({(e.held_name, e.acq_name)
                           for e in self._edges.values()})

    def report(self) -> str:
        inv = self.inversions()
        lines = [f"lock-witness: {self.acquisitions} acquisitions, "
                 f"{self.witnessed_locks} witnessed locks, "
                 f"{len(self._edges)} order edges, "
                 f"{len(inv)} inversions"]
        for ab, ba in inv:
            lines.append("INVERSION:")
            lines.append("  " + ab.describe().replace("\n", "\n  "))
            lines.append("  " + ba.describe().replace("\n", "\n  "))
        return "\n".join(lines)

    def assert_clean(self):
        inv = self.inversions()
        if inv:
            raise AssertionError(
                f"lock-witness detected {len(inv)} lock-order "
                f"inversion(s):\n{self.report()}")
