"""repro_torch.serve — multi-tenant serving front end (ROADMAP north star).

:class:`BlasxServer` multiplexes concurrent clients onto a pool of
warm :class:`~repro_torch.api.BlasxContext`s: bounded admission with
priority classes and tenant-fair dequeue, affinity routing to the
context holding a tenant's warm tiles, per-tenant ALRU quotas for
cache isolation, and a per-tenant latency ledger.

Quickstart::

    from repro_torch.serve import BlasxServer, INTERACTIVE

    with BlasxServer(pool_size=2,
                     quotas={"tenant-a": 8 << 20}) as srv:
        w = srv.tile("tenant-b", weights)        # warm handle, home ctx
        f = srv.submit("tenant-b", "gemm", x, w, priority=INTERACTIVE)
        y = f.result().array()
        print(srv.stats()["tenants"]["tenant-b"]["latency_p99_ms"])

``python -m repro_torch.serve --demo`` drives a two-tenant smoke
scenario on the card (``--device cpu`` on the host).
"""
from .admission import (BATCH, DEFAULT_BOOSTS, INTERACTIVE,
                        PRIORITY_CLASSES, AdmissionQueue, ServeRequest)
from .server import BlasxServer
from .stats import ServerStats, percentile

__all__ = [
    "BlasxServer", "AdmissionQueue", "ServeRequest", "ServerStats",
    "percentile", "INTERACTIVE", "BATCH", "PRIORITY_CLASSES",
    "DEFAULT_BOOSTS",
]
