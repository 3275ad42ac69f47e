"""Per-tenant serving ledger.

The runtime's ledgers count bytes and tasks; the serving layer adds
the client-visible half — latency and queue-wait percentiles, shed
load, cancellations — keyed by tenant.  Sample windows are bounded
(last ``window`` samples per tenant) so a long-lived server's stats
stay O(1) in memory; counters are lifetime.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Deque, Dict, List, Optional

DEFAULT_WINDOW = 4096


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on no samples."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[min(rank, len(xs)) - 1]


class _TenantLedger:
    __slots__ = ("latencies", "waits", "completed", "failed",
                 "rejected", "cancelled")

    def __init__(self, window: int):
        self.latencies: Deque[float] = deque(maxlen=window)
        self.waits: Deque[float] = deque(maxlen=window)
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.cancelled = 0


class _TenantBook:
    """The per-tenant ledgers of one :class:`ServerStats`, under one
    lock.

    A class of its own rather than fields of ``ServerStats`` because
    the reference's lock-order lint (``repro.analysis``) keys
    lock-owning classes by their bare name: a port class named
    ``ServerStats`` that declared a lock would take the place of the
    reference's in that graph.  Its methods are named so that the
    lint's by-name call resolution cannot confuse them with another
    class's.
    """

    _GUARDED_BY = {"_lock": ("_tenants",)}

    def __init__(self, window: int):
        self._window = window
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantLedger] = {}

    def _ledger_locked(self, tenant: str) -> _TenantLedger:
        led = self._tenants.get(tenant)
        if led is None:
            led = self._tenants[tenant] = _TenantLedger(self._window)
        return led

    def note_result(self, tenant: str, wait_s: float, latency_s: float,
                    ok: bool) -> None:
        with self._lock:
            led = self._ledger_locked(tenant)
            led.waits.append(wait_s)
            led.latencies.append(latency_s)
            if ok:
                led.completed += 1
            else:
                led.failed += 1

    def note_rejection(self, tenant: str) -> None:
        with self._lock:
            self._ledger_locked(tenant).rejected += 1

    def note_cancel(self, tenant: str) -> None:
        with self._lock:
            self._ledger_locked(tenant).cancelled += 1

    def latencies_of(self, tenant: str) -> List[float]:
        with self._lock:
            led = self._tenants.get(tenant)
            return list(led.latencies) if led else []

    def tenant_rows(self):
        """``(tenant, counters, latencies, waits)`` per tenant, copied
        under the lock."""
        with self._lock:
            return [(t, (led.completed, led.failed, led.rejected,
                         led.cancelled), list(led.latencies),
                     list(led.waits))
                    for t, led in self._tenants.items()]


class ServerStats:
    """Thread-safe per-tenant counters + latency/wait percentiles."""

    def __init__(self, window: int = DEFAULT_WINDOW):
        self._book = _TenantBook(window)

    # ----------------------------------------------------------- recording
    def record(self, tenant: str, wait_s: float, latency_s: float,
               ok: bool) -> None:
        self._book.note_result(tenant, wait_s, latency_s, ok)

    def record_rejection(self, tenant: str) -> None:
        self._book.note_rejection(tenant)

    def record_cancelled(self, tenant: str) -> None:
        self._book.note_cancel(tenant)

    # ------------------------------------------------------------ reporting
    def tenant_p99(self, tenant: str) -> float:
        return percentile(self._book.latencies_of(tenant), 99.0)

    def snapshot(self, quota_evictions: Optional[Dict[str, int]] = None
                 ) -> Dict[str, Dict[str, float]]:
        """Per-tenant dict: counters plus p50/p99 latency and queue
        wait in milliseconds.  ``quota_evictions`` (tenant -> count,
        from the ALRU owner ledgers) is merged in when given."""
        out: Dict[str, Dict[str, float]] = {}
        for tenant, counts, lats, waits in self._book.tenant_rows():
            completed, failed, rejected, cancelled = counts
            out[tenant] = {
                "completed": completed,
                "failed": failed,
                "rejected": rejected,
                "cancelled": cancelled,
                "latency_p50_ms": percentile(lats, 50.0) * 1e3,
                "latency_p99_ms": percentile(lats, 99.0) * 1e3,
                "queue_wait_p50_ms": percentile(waits, 50.0) * 1e3,
                "queue_wait_p99_ms": percentile(waits, 99.0) * 1e3,
                "quota_evictions": (quota_evictions or {}).get(tenant, 0),
            }
        # quota'd tenants that never completed a request still show up
        for tenant, n in (quota_evictions or {}).items():
            if tenant not in out:
                out[tenant] = {
                    "completed": 0, "failed": 0, "rejected": 0,
                    "cancelled": 0, "latency_p50_ms": 0.0,
                    "latency_p99_ms": 0.0, "queue_wait_p50_ms": 0.0,
                    "queue_wait_p99_ms": 0.0, "quota_evictions": n,
                }
        return out
