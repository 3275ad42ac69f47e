"""`BlasxServer` — multi-tenant serving front end over warm contexts.

The runtime stack below this module is single-lane: one
:class:`~repro_torch.api.BlasxContext` serializes its routine calls because
the runtime's scheduling pass is not re-entrant.  The server is the
front door the ROADMAP's "millions of users" shape needs — it
multiplexes many concurrent clients onto a *pool* of contexts:

admission   a single bounded
            :class:`~repro_torch.serve.admission.AdmissionQueue`
            (interactive before batch, tenants round-robin within a
            class); at the bound, ``submit`` sheds load with
            :class:`~repro_torch.api.BackpressureError`.
affinity    a tenant's requests route to the context already holding
            its warm tiles/handles; new tenants and overflow beyond
            ``overflow_depth`` spill to the least-loaded context.
            Requests carrying a :class:`~repro_torch.api.MatrixHandle` are
            pinned to the handle's own context (handles never cross
            contexts).
isolation   per-tenant ALRU quotas (``quotas=``) tag every cached tile
            with its owner; once any quota exists, cross-tenant
            eviction is off — a flooding tenant recycles its own
            blocks, never another tenant's warm set.
priority    each request's class maps to an additive Eq. 3 term
            (``priority_boosts``), so interactive tasks outrank batch
            tasks inside every reservation station they share.

One worker thread drains each context's lane (the context lane stays
serial; concurrency comes from pool width).  ``stats()`` merges the
:class:`~repro_torch.serve.stats.ServerStats` ledger with the ALRU
quota-eviction counters.
"""
from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Union

from ..api.context import BlasxContext, MatrixHandle
from ..api.futures import BackpressureError, BlasFuture
from ..core.runtime import RuntimeConfig
from .admission import (BATCH, DEFAULT_BOOSTS, INTERACTIVE,
                        PRIORITY_CLASSES, AdmissionQueue, ServeRequest)
from .stats import ServerStats

__all__ = ["BlasxServer", "INTERACTIVE", "BATCH"]

_TAKE_TIMEOUT_S = 0.05  # worker poll granularity on an idle lane


class _Routing:
    """The affinity map, per-lane load and tenant counts and the closed
    flag of one :class:`BlasxServer`, under one lock.

    A class of its own rather than fields of ``BlasxServer`` because
    the reference's lock-order lint (``repro.analysis``) keys
    lock-owning classes by their bare name: a port class named
    ``BlasxServer`` that declared a lock would take the place of the
    reference's server in that graph.  Its methods are named so that
    the lint's by-name call resolution cannot confuse them with another
    class's.
    """

    _GUARDED_BY = {"_lock": (
        "_affinity", "_lane_load", "_lane_tenants", "_closed")}

    def __init__(self, n_lanes: int, overflow_depth: int):
        self._overflow_depth = overflow_depth
        self._lock = threading.Lock()
        self._affinity: Dict[str, int] = {}
        self._lane_load = [0] * n_lanes      # queued + running per lane
        self._lane_tenants = [0] * n_lanes   # tenants homed per lane
        self._closed = False

    def mark_closed(self) -> bool:
        """True only for the call that closed the server."""
        with self._lock:
            if self._closed:
                return False
            self._closed = True
            return True

    def is_closed(self) -> bool:
        with self._lock:
            return self._closed

    def home_of(self, tenant: str) -> Optional[int]:
        with self._lock:
            return self._affinity.get(tenant)

    def home_lane(self, tenant: str) -> int:
        with self._lock:
            return self._assign_affinity_locked(tenant)

    def place_request(self, req: ServeRequest, pinned: Optional[int],
                      queue: AdmissionQueue) -> bool:
        """Pick ``req``'s lane (its pinned one, else affinity with
        overflow) and offer it to ``queue``; the lane's load counts it
        when admitted."""
        with self._lock:
            if pinned is not None:
                req.lane = pinned
                if req.tenant not in self._affinity:
                    self._affinity[req.tenant] = pinned
                    self._lane_tenants[pinned] += 1
            else:
                req.lane = self._route_locked(req.tenant)
            admitted = queue.offer(req)
            if admitted:
                self._lane_load[req.lane] += 1
            return admitted

    def lane_finished(self, lane: int) -> None:
        with self._lock:
            self._lane_load[lane] -= 1

    def lane_view(self):
        """``(lane_load, affinity)`` copies."""
        with self._lock:
            return list(self._lane_load), dict(self._affinity)

    def _assign_affinity_locked(self, tenant: str) -> int:
        """A new tenant homes on the lane with the least load, breaking
        ties toward the lane hosting the fewest tenants — tenants
        spread across the pool instead of piling onto lane 0."""
        lane = self._affinity.get(tenant)
        if lane is None:
            lane = min(range(len(self._lane_load)),
                       key=lambda i: (self._lane_load[i],
                                      self._lane_tenants[i], i))
            self._affinity[tenant] = lane
            self._lane_tenants[lane] += 1
        return lane

    def _route_locked(self, tenant: str) -> int:
        """Affinity lane unless it is ``overflow_depth`` deeper than
        the shallowest lane; overflow goes to the least-loaded lane
        without moving affinity — the warm set stays where it is."""
        home = self._assign_affinity_locked(tenant)
        coldest = min(range(len(self._lane_load)),
                      key=lambda i: (self._lane_load[i], i))
        if self._lane_load[home] - self._lane_load[coldest] \
                > self._overflow_depth:
            return coldest
        return home


class BlasxServer:
    """Serve L3 BLAS traffic from a pool of warm ``BlasxContext``s.

    Parameters
    ----------
    config:
        ``RuntimeConfig`` used to build each pooled context (default:
        2-device sim on the card; pass ``device="cpu"`` in it to serve
        from the host).  Mutually exclusive with ``contexts``.
    contexts:
        Pre-built contexts to adopt (the caller keeps ownership:
        ``close()`` will not close them).
    pool_size:
        Number of contexts to build when ``contexts`` is not given.
    max_depth:
        Admission-queue bound across all lanes/classes/tenants.
    overflow_depth:
        A tenant's home lane may run this many requests deeper than
        the shallowest lane before its traffic overflows there.
    quotas:
        ``tenant -> bytes`` resident-tile caps, applied to every
        pooled context (see ``Alru.set_quota``).
    priority_boosts:
        ``class -> additive Eq. 3 term`` (default interactive=+3,
        batch=+0).

    All pooled contexts compute on one card, each with its own tile
    caches in its memory: size ``cache_bytes`` so the pool fits.
    """

    def __init__(self, config: Optional[RuntimeConfig] = None, *,
                 contexts: Optional[Sequence[BlasxContext]] = None,
                 pool_size: int = 2,
                 tile: Optional[int] = None,
                 max_depth: int = 64,
                 overflow_depth: int = 4,
                 quotas: Optional[Dict[str, int]] = None,
                 priority_boosts: Optional[Dict[str, float]] = None):
        if contexts is not None and config is not None:
            raise ValueError("pass config= or contexts=, not both")
        if contexts is not None:
            if not contexts:
                raise ValueError("contexts must be non-empty")
            self._contexts = list(contexts)
            self._owns_contexts = False
        else:
            if pool_size < 1:
                raise ValueError("pool_size must be >= 1")
            cfg = config or RuntimeConfig(n_devices=2, mode="sim")
            kw = {"tile": tile} if tile is not None else {}
            self._contexts = [BlasxContext(cfg, **kw)
                              for _ in range(pool_size)]
            self._owns_contexts = True
        n = len(self._contexts)
        self._boosts = dict(DEFAULT_BOOSTS)
        if priority_boosts:
            for cls in priority_boosts:
                if cls not in PRIORITY_CLASSES:
                    raise ValueError(f"unknown priority class {cls!r}")
            self._boosts.update(priority_boosts)
        self._queue = AdmissionQueue(max_depth=max_depth, n_lanes=n)
        self._stats = ServerStats()
        self._routing = _Routing(n, overflow_depth)
        if quotas:
            for tenant, nbytes in quotas.items():
                self.set_tenant_quota(tenant, nbytes)
        self._workers = [
            threading.Thread(target=self._worker, args=(i,),
                             name=f"blasx-serve-{i}", daemon=True)
            for i in range(n)
        ]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "BlasxServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, wait: bool = True) -> None:
        """Stop admitting, then either drain queued work (``wait=True``)
        or cancel it; workers exit once their lane is empty.  Owned
        contexts are closed, adopted ones are left to their owner.
        Idempotent."""
        if not self._routing.mark_closed():
            return
        self._queue.close()
        if not wait:
            for lane in range(len(self._contexts)):
                for req in self._queue.drain(lane):
                    if req.future.cancel():
                        self._stats.record_cancelled(req.tenant)
                    self._routing.lane_finished(req.lane)
        for w in self._workers:
            w.join()
        if self._owns_contexts:
            for ctx in self._contexts:
                ctx.close()

    @property
    def closed(self) -> bool:
        return self._routing.is_closed()

    @property
    def pool_size(self) -> int:
        return len(self._contexts)

    # ------------------------------------------------------------- tenants
    def set_tenant_quota(self, tenant: str,
                         nbytes: Optional[int]) -> None:
        """Cap ``tenant``'s resident tile bytes on every pooled
        context's devices (None removes the cap)."""
        for ctx in self._contexts:
            ctx.set_tenant_quota(tenant, nbytes)

    def tile(self, tenant: str, data, **kwargs) -> MatrixHandle:
        """Register a warm handle for ``tenant`` on its home context
        (assigning affinity for a new tenant) and return it.  Requests
        that later carry the handle are pinned to that context."""
        self._check_open()
        lane = self._routing.home_lane(tenant)
        return self._contexts[lane].tile(data, **kwargs)

    def context_of(self, tenant: str) -> Optional[int]:
        """The tenant's home lane (None before its first request)."""
        return self._routing.home_of(tenant)

    # ------------------------------------------------------------ serving
    def submit(self, tenant: str,
               routine: Union[str, Callable[..., Any]], *args,
               priority: str = BATCH, **kwargs) -> BlasFuture:
        """Admit one request; returns a :class:`BlasFuture` (supports
        ``cancel()`` while still queued).  ``routine`` is a context
        method name (``"gemm"`` ...) or a callable invoked as
        ``routine(ctx, *args, **kwargs)``.  Raises
        :class:`BackpressureError` when the admission queue is full."""
        self._check_open()
        fut = concurrent.futures.Future()
        req = ServeRequest(tenant=tenant, routine=routine, args=args,
                           kwargs=kwargs, priority=priority, future=fut,
                           t_submit=time.perf_counter())
        pinned = self._pinned_lane(args, kwargs)
        if not self._routing.place_request(req, pinned, self._queue):
            self._stats.record_rejection(tenant)
            raise BackpressureError(
                f"admission queue full (max_depth="
                f"{self._queue.max_depth}); request for tenant "
                f"{tenant!r} rejected")
        return BlasFuture(fut)

    # ------------------------------------------------------------- routing
    def _pinned_lane(self, args, kwargs) -> Optional[int]:
        """Handles never cross contexts: a request carrying one is
        pinned to the context that owns it."""
        for x in list(args) + list(kwargs.values()):
            if isinstance(x, MatrixHandle):
                for i, ctx in enumerate(self._contexts):
                    if x._ctx is ctx:
                        return i
                raise ValueError(
                    f"handle {x.matrix_id} belongs to a context "
                    "outside this server's pool")
        return None

    # ------------------------------------------------------------- workers
    def _worker(self, lane: int) -> None:
        ctx = self._contexts[lane]
        while True:
            req = self._queue.take(lane, timeout=_TAKE_TIMEOUT_S)
            if req is None:
                if self._queue.closed:
                    return
                continue
            try:
                if not req.future.set_running_or_notify_cancel():
                    self._stats.record_cancelled(req.tenant)
                    continue
                req.t_start = time.perf_counter()
                boost = self._boosts[req.priority]
                try:
                    with ctx.request_scope(tenant=req.tenant,
                                           priority_boost=boost):
                        if isinstance(req.routine, str):
                            fn = getattr(ctx, req.routine, None)
                            if fn is None or not callable(fn):
                                raise ValueError(
                                    f"unknown routine {req.routine!r}")
                            result = fn(*req.args, **req.kwargs)
                        else:
                            result = req.routine(ctx, *req.args,
                                                 **req.kwargs)
                except BaseException as exc:
                    # the worker is a boundary that must keep serving:
                    # the failure goes to the caller through its future
                    req.future.set_exception(exc)
                    ok = False
                else:
                    req.future.set_result(result)
                    ok = True
                done = time.perf_counter()
                self._stats.record(req.tenant,
                                   wait_s=req.t_start - req.t_submit,
                                   latency_s=done - req.t_submit, ok=ok)
            finally:
                self._routing.lane_finished(req.lane)

    # --------------------------------------------------------------- stats
    def quota_evictions(self) -> Dict[str, int]:
        """Tenant -> quota-eviction count summed over every pooled
        context's devices."""
        out: Dict[str, int] = {}
        for ctx in self._contexts:
            for d in ctx.runtime.devices:
                for tenant, n in d.alru.quota_evictions_by_owner.items():
                    out[tenant] = out.get(tenant, 0) + n
        return out

    def stats(self) -> Dict[str, Any]:
        """Server-level ledger: per-tenant latency/wait percentiles and
        counters (rejections, cancellations, quota evictions), queue
        depth, per-lane load and affinity map."""
        lane_load, affinity = self._routing.lane_view()
        return {
            "pool_size": self.pool_size,
            "queue_depth": self._queue.depth,
            "lane_load": lane_load,
            "affinity": affinity,
            "tenants": self._stats.snapshot(self.quota_evictions()),
        }

    # ------------------------------------------------------------- helpers
    def _check_open(self) -> None:
        if self._routing.is_closed():
            raise RuntimeError("BlasxServer is closed")
