"""Admission control for the serving front end.

One bounded queue fronts the whole context pool.  Internally the queue
is laned — one lane per pool context, chosen by the dispatcher's
affinity routing at submit time — and each lane keeps two priority
classes (``interactive`` drains strictly before ``batch``) of
per-tenant FIFO deques.  Within a class, tenants are served
round-robin: a tenant that just got a request dequeued rotates to the
back, so a flood from one tenant costs every other tenant at most one
queue position per turn.  The depth bound is global across lanes and
classes — admission is the single place load is shed.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, Optional, Tuple, Union

INTERACTIVE = "interactive"
BATCH = "batch"
PRIORITY_CLASSES = (INTERACTIVE, BATCH)

# Eq. 3 additive term per class: locality contributes +2 (L1) / +1
# (L2) per input tile, so +3.0 lets one interactive task outrank a
# batch task even when the batch task has every input L1-resident.
DEFAULT_BOOSTS: Dict[str, float] = {INTERACTIVE: 3.0, BATCH: 0.0}


@dataclasses.dataclass
class ServeRequest:
    """One client submission travelling through the server."""
    tenant: str
    routine: Union[str, Callable[..., Any]]
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    priority: str = BATCH
    lane: int = 0
    future: Any = None                  # concurrent.futures.Future
    t_submit: float = 0.0               # perf_counter at admission
    t_start: float = 0.0                # perf_counter at dequeue

    def __post_init__(self):
        if self.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"priority must be one of {PRIORITY_CLASSES}, "
                f"got {self.priority!r}")


class _LaneBook:
    """The lanes, depth and closed flag of one :class:`AdmissionQueue`,
    under one lock (``_nonempty`` is a condition over it).

    A class of its own rather than fields of ``AdmissionQueue`` because
    the reference's lock-order lint (``repro.analysis``) keys
    lock-owning classes by their bare name: a port class named
    ``AdmissionQueue`` that declared a lock would take the place of the
    reference's queue in that graph.  Its methods are named so that the
    lint's by-name call resolution cannot confuse them with another
    class's.
    """

    _GUARDED_BY = {"_lock": ("_closed", "_depth", "_lanes")}
    _LOCK_ALIASES = {"_nonempty": "_lock"}

    def __init__(self, max_depth: int, n_lanes: int):
        self.max_depth = max_depth
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._closed = False
        self._depth = 0
        # lane -> class -> tenant -> FIFO of requests.  OrderedDict
        # order IS the round-robin order; move_to_end on dequeue.
        self._lanes = [
            {cls: OrderedDict() for cls in PRIORITY_CLASSES}
            for _ in range(n_lanes)
        ]

    def depth_now(self) -> int:
        with self._lock:
            return self._depth

    def is_shut(self) -> bool:
        with self._lock:
            return self._closed

    def lane_size(self, lane: int) -> int:
        with self._lock:
            return sum(len(q) for cls in self._lanes[lane].values()
                       for q in cls.values())

    def admit_request(self, req: ServeRequest) -> bool:
        with self._lock:
            if self._closed or self._depth >= self.max_depth:
                return False
            tenants = self._lanes[req.lane][req.priority]
            q = tenants.get(req.tenant)
            if q is None:
                q = tenants[req.tenant] = deque()
            q.append(req)
            self._depth += 1
            self._nonempty.notify_all()
            return True

    def next_for_lane(self, lane: int,
                      timeout: Optional[float]) -> Optional[ServeRequest]:
        with self._lock:
            while True:
                req = self._pop_locked(lane)
                if req is not None:
                    self._depth -= 1
                    return req
                if self._closed:
                    return None
                if not self._nonempty.wait(timeout=timeout):
                    return None

    def _pop_locked(self, lane: int) -> Optional[ServeRequest]:
        for cls in PRIORITY_CLASSES:
            tenants = self._lanes[lane][cls]
            for tenant, q in tenants.items():
                req = q.popleft()
                if q:
                    tenants.move_to_end(tenant)  # rotate to the back
                else:
                    del tenants[tenant]
                return req
        return None

    def empty_lane(self, lane: int) -> list:
        out = []
        with self._lock:
            while True:
                req = self._pop_locked(lane)
                if req is None:
                    return out
                self._depth -= 1
                out.append(req)

    def shut(self) -> None:
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()


class AdmissionQueue:
    """Bounded, laned, priority-classed, tenant-fair request queue."""

    def __init__(self, max_depth: int = 64, n_lanes: int = 1):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        if n_lanes < 1:
            raise ValueError("n_lanes must be >= 1")
        self.max_depth = max_depth
        self.n_lanes = n_lanes
        self._book = _LaneBook(max_depth, n_lanes)

    # ------------------------------------------------------------- queries
    @property
    def depth(self) -> int:
        return self._book.depth_now()

    @property
    def closed(self) -> bool:
        return self._book.is_shut()

    def lane_depth(self, lane: int) -> int:
        return self._book.lane_size(lane)

    # ----------------------------------------------------------- mutations
    def offer(self, req: ServeRequest) -> bool:
        """Admit ``req`` into its lane; False when the queue is at its
        depth bound or closed (the caller records the rejection)."""
        return self._book.admit_request(req)

    def take(self, lane: int = 0,
             timeout: Optional[float] = None) -> Optional[ServeRequest]:
        """Next request for ``lane``: interactive before batch, tenants
        round-robin within a class.  Blocks up to ``timeout`` seconds;
        returns None on timeout, or immediately once the queue is
        closed and the lane is drained."""
        return self._book.next_for_lane(lane, timeout)

    def drain(self, lane: int) -> list:
        """Remove and return every queued request for ``lane`` (close
        path: the server cancels their futures)."""
        return self._book.empty_lane(lane)

    def close(self) -> None:
        """Refuse new offers and wake every blocked ``take``; queued
        requests remain takeable (drain-on-close)."""
        self._book.shut()
