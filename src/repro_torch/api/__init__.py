"""repro_torch.api — the two-layer public BLAS API of the PyTorch port.

High-level layer (recommended): :class:`BlasxContext` — a persistent
handle (cuBLAS-handle analogue) whose ALRU/MESI-X tile caches stay
warm across calls, with :class:`MatrixHandle` operands, per-call
ledger snapshots (:class:`CallRecord`), async submission
(:class:`BlasFuture`) and batched GEMM for serving-shaped workloads.

Low-level layer: ``repro_torch.api.cblas`` — strict CBLAS signatures in
both precisions (``cblas_dgemm`` / ``cblas_sgemm`` et al.) with
order/leading-dimension semantics and in-place updates of the caller's
numpy output buffer, for legacy callers.

The legacy array-in/array-out functions in ``repro_torch.core.blas3``
are thin wrappers over :func:`default_context`.  Every surface computes
on the card unless its context was built with ``device="cpu"``.
"""
from .batch import gemm_batched, gemm_strided_batched
from .cblas import (CblasColMajor, CblasLeft, CblasLower, CblasNonUnit,
                    CblasNoTrans, CblasRight, CblasRowMajor, CblasTrans,
                    CblasConjTrans, CblasUnit, CblasUpper, cblas_dgemm,
                    cblas_dsymm, cblas_dsyr2k, cblas_dsyrk, cblas_dtrmm,
                    cblas_dtrsm, cblas_sgemm, cblas_ssymm, cblas_ssyr2k,
                    cblas_ssyrk, cblas_strmm, cblas_strsm)
from .context import (BlasxContext, CallRecord, MatrixHandle,
                      default_context, set_default_context)
from .futures import BackpressureError, BlasFuture, SerialExecutor

__all__ = [
    "BlasxContext", "MatrixHandle", "CallRecord", "BlasFuture",
    "BackpressureError", "SerialExecutor",
    "default_context", "set_default_context",
    "gemm_batched", "gemm_strided_batched",
    "cblas_dgemm", "cblas_dsymm", "cblas_dsyrk", "cblas_dsyr2k",
    "cblas_dtrmm", "cblas_dtrsm",
    "cblas_sgemm", "cblas_ssymm", "cblas_ssyrk", "cblas_ssyr2k",
    "cblas_strmm", "cblas_strsm",
    "CblasRowMajor", "CblasColMajor", "CblasNoTrans", "CblasTrans",
    "CblasConjTrans", "CblasUpper", "CblasLower", "CblasNonUnit",
    "CblasUnit", "CblasLeft", "CblasRight",
]
