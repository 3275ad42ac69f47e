"""repro_torch.api — the persistent-handle BLAS API of the PyTorch port.

:class:`BlasxContext` is a persistent handle (cuBLAS-handle analogue)
whose ALRU/MESI-X tile caches stay warm across calls, with
:class:`MatrixHandle` operands and per-call ledger snapshots
(:class:`CallRecord`).  The legacy array-in/array-out functions in
``repro_torch.core.blas3`` are thin wrappers over
:func:`default_context`.

Not ported yet: asynchronous submission (``api/futures.py``), batched
GEMM (``api/batch.py``) and the CBLAS layer (``api/cblas.py``).
"""
from .context import (BlasxContext, CallRecord, MatrixHandle,
                      backend_context, default_context, set_default_context)

__all__ = [
    "BlasxContext", "MatrixHandle", "CallRecord",
    "default_context", "backend_context", "set_default_context",
]
