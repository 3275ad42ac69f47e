"""CBLAS-compatible legacy layer (the paper's backward-compatibility
goal, after the GSL two-layer design).

Strict C-interface signatures for the six L3 routines in both
precisions — double (``cblas_dgemm``, ``cblas_dsymm``, ``cblas_dsyrk``,
``cblas_dsyr2k``, ``cblas_dtrmm``, ``cblas_dtrsm``) and single
(``cblas_sgemm``, ``cblas_ssymm``, ``cblas_ssyrk``, ``cblas_ssyr2k``,
``cblas_strmm``, ``cblas_strsm``) — with order/trans/side/uplo/diag
enums, explicit leading dimensions, and in-place updates of the output
buffer, all executed by a persistent :class:`~repro_torch.api.BlasxContext`
(the module default, on the card, unless ``ctx=`` is given — pass a
``BlasxContext(device="cpu")`` to compute on the host).  The two
precision families share one implementation parameterized by dtype;
the ``d`` routines run float64 end to end (f64 tiles accumulate in f64
on the card), the ``s`` routines float32 (see
``repro_torch.core.dtypes``).

Buffers may be

* flat 1-D arrays of the routine's dtype, interpreted through ``ld``
  under the given ``Order`` exactly as C callers lay them out, or
* 2-D numpy arrays of the routine's logical shape.  ``ld`` must then
  describe the array's actual memory layout: the dense leading
  dimension, or — for a strided view into padded storage — the padded
  one (a ``ld`` that matches neither raises instead of silently
  reading the wrong elements).

The output buffer (``C`` for gemm/symm/syrk/syr2k, ``B`` for
trmm/trsm) must be exactly the routine's dtype and writable — the
routines update it in place and return ``None``, as legacy callers
expect.  Operands are read through ``torch.from_numpy`` views of the
caller's memory (no copy, strides and all); the result is written back
with one numpy assignment into the caller's (possibly padded) view.

Every routine also takes keyword-only ``tile=``: an int pins the tile
size, ``"auto"`` resolves it through the runtime autotuner
(``repro_torch.tuning``) for the call's routine/shape/dtype, and ``None``
(default) keeps the context default.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .context import BlasxContext, backend_context, default_context

# ------------------------------------------------------ CBLAS enum values
CblasRowMajor = 101
CblasColMajor = 102
CblasNoTrans = 111
CblasTrans = 112
CblasConjTrans = 113   # == Trans for real matrices
CblasUpper = 121
CblasLower = 122
CblasNonUnit = 131
CblasUnit = 132
CblasLeft = 141
CblasRight = 142

_TRANS = {CblasNoTrans: "N", CblasTrans: "T", CblasConjTrans: "T",
          "N": "N", "T": "T", "C": "T", "n": "N", "t": "T", "c": "T"}
_UPLO = {CblasUpper: "U", CblasLower: "L", "U": "U", "L": "L",
         "u": "U", "l": "L"}
_DIAG = {CblasNonUnit: "N", CblasUnit: "U", "N": "N", "U": "U",
         "n": "N", "u": "U"}
_SIDE = {CblasLeft: "L", CblasRight: "R", "L": "L", "R": "R",
         "l": "L", "r": "R"}


def _flag(table, value, what: str) -> str:
    try:
        return table[value]
    except KeyError:
        raise ValueError(f"invalid {what} flag: {value!r}") from None


def _view(buf, rows: int, cols: int, ld: int, order: int, name: str,
          writable: bool = False, dtype=np.float64) -> np.ndarray:
    """Logical ``rows x cols`` view of a CBLAS buffer.

    Flat buffers follow the C convention: element (i, j) lives at
    ``i*ld + j`` (row major) or ``i + j*ld`` (column major).  The
    returned array is a *view* whenever numpy allows, which is what
    makes the in-place output update visible to the caller.

    ``dtype`` is the routine's precision (float64 for the ``d``
    family, float32 for ``s``): output buffers must match it exactly;
    read-only inputs of other dtypes are cast.
    """
    dtype = np.dtype(dtype)
    if writable and not isinstance(buf, np.ndarray):
        # np.asarray on a list would update a detached copy and the
        # caller's buffer would silently keep its old contents
        raise TypeError(f"{name}: output buffer must be a numpy array, "
                        f"got {type(buf).__name__}")
    a = np.asarray(buf)
    if writable:
        if a.dtype != dtype:
            raise TypeError(f"{name}: output buffer must be {dtype.name}, "
                            f"got {a.dtype}")
        if not a.flags.writeable:
            raise ValueError(f"{name}: output buffer is read-only")
    if a.ndim == 2:
        if a.shape != (rows, cols):
            raise ValueError(f"{name}: expected shape ({rows},{cols}), "
                             f"got {a.shape}")
        if order not in (CblasRowMajor, CblasColMajor):
            raise ValueError(f"invalid Order flag: {order!r}")
        dense_ld = cols if order == CblasRowMajor else rows
        if ld < dense_ld:
            raise ValueError(f"{name}: ld {ld} < {dense_ld}")
        if ld > dense_ld:
            # A padded leading dimension is only meaningful when the
            # 2-D array's memory really is strided that way (a view
            # into padded storage).  A dense array with ld > dense_ld
            # used to be accepted and silently given dense semantics —
            # the C caller meant element (i, j) at i*ld + j, which this
            # buffer does not contain.  Honor matching strides; raise
            # otherwise.  Checked on the CALLER's buffer, before any
            # read-only dtype cast (a cast copy is dense and would
            # fail the check for perfectly valid strided inputs).
            # With a single row (row major) / column (col major) the
            # leading stride is never exercised, so any ld is valid.
            it = a.itemsize
            single = rows == 1 if order == CblasRowMajor else cols == 1
            strided_ok = single or (
                a.strides == (ld * it, it) if order == CblasRowMajor
                else a.strides == (it, ld * it))
            if not strided_ok:
                raise ValueError(
                    f"{name}: ld {ld} does not match the 2-D buffer's "
                    f"memory layout (dense leading dimension {dense_ld}, "
                    f"strides {a.strides}); pass a strided view into the "
                    f"padded storage or ld={dense_ld}")
        if a.dtype != dtype:
            a = a.astype(dtype)   # read-only inputs: writable returned above
        return a
    if a.ndim != 1:
        raise ValueError(f"{name}: expected 1-D or 2-D buffer, "
                         f"got {a.ndim}-D")
    if a.dtype != dtype:
        a = a.astype(dtype)       # flat read-only input: cast copy is fine
    if order == CblasRowMajor:
        if ld < max(1, cols):
            raise ValueError(f"{name}: ld {ld} < n cols {cols}")
        if a.size < rows * ld:
            raise ValueError(f"{name}: buffer too small "
                             f"({a.size} < {rows * ld})")
        return a[:rows * ld].reshape(rows, ld)[:, :cols]
    if order == CblasColMajor:
        if ld < max(1, rows):
            raise ValueError(f"{name}: ld {ld} < n rows {rows}")
        if a.size < cols * ld:
            raise ValueError(f"{name}: buffer too small "
                             f"({a.size} < {cols * ld})")
        return a[:cols * ld].reshape(cols, ld).T[:rows, :]
    raise ValueError(f"invalid Order flag: {order!r}")


def _ctx(ctx: Optional[BlasxContext],
         backend: Optional[str] = None,
         device_class: Optional[str] = None,
         mesh: Optional[int] = None) -> BlasxContext:
    if ctx is not None:
        if backend is not None and ctx.cfg.backend != backend:
            raise ValueError(
                f"backend={backend!r} conflicts with ctx backend "
                f"{ctx.cfg.backend!r}")
        if (device_class is not None
                and ctx.cfg.device_class != device_class):
            raise ValueError(
                f"device_class={device_class!r} conflicts with ctx "
                f"device class {ctx.cfg.device_class!r}")
        if mesh is not None and ctx.cfg.mesh_devices != mesh:
            raise ValueError(
                f"mesh={mesh} conflicts with ctx mesh_devices "
                f"{ctx.cfg.mesh_devices}")
        return ctx
    if device_class is not None or mesh is not None:
        # pod-tier call without a context: private per-call context
        # (mirrors blas3's config= semantics)
        return BlasxContext(backend=backend, device_class=device_class,
                            mesh=mesh)
    if backend is None:
        return default_context()
    # calls sharing a backend share one warm-cache module context
    return backend_context(backend)


# ============================================= dtype-parameterized bodies
def _gemm(dtype, order, transa, transb, m, n, k, alpha, A, lda, B, ldb,
          beta, C, ldc, ctx, backend, tile=None, device_class=None,
          mesh=None) -> None:
    ta, tb = _flag(_TRANS, transa, "Trans"), _flag(_TRANS, transb, "Trans")
    ar, ac = (m, k) if ta == "N" else (k, m)
    br, bc = (k, n) if tb == "N" else (n, k)
    Av = _view(A, ar, ac, lda, order, "A", dtype=dtype)
    Bv = _view(B, br, bc, ldb, order, "B", dtype=dtype)
    Cv = _view(C, m, n, ldc, order, "C", writable=True, dtype=dtype)
    c = _ctx(ctx, backend, device_class, mesh)
    out = c.gemm(Av, Bv, Cv if beta != 0.0 else None,
                 alpha=alpha, beta=beta, transa=ta,
                 transb=tb, tile=tile, dtype=dtype)
    Cv[...] = out.array()


def _symm(dtype, order, side, uplo, m, n, alpha, A, lda, B, ldb, beta,
          C, ldc, ctx, backend, tile=None, device_class=None,
          mesh=None) -> None:
    sd, ul = _flag(_SIDE, side, "Side"), _flag(_UPLO, uplo, "Uplo")
    ka = m if sd == "L" else n
    Av = _view(A, ka, ka, lda, order, "A", dtype=dtype)
    Bv = _view(B, m, n, ldb, order, "B", dtype=dtype)
    Cv = _view(C, m, n, ldc, order, "C", writable=True, dtype=dtype)
    c = _ctx(ctx, backend, device_class, mesh)
    out = c.symm(Av, Bv, Cv if beta != 0.0 else None,
                 alpha=alpha, beta=beta, side=sd, uplo=ul,
                 tile=tile, dtype=dtype)
    Cv[...] = out.array()


def _syrk(dtype, order, uplo, trans, n, k, alpha, A, lda, beta, C, ldc,
          ctx, backend, tile=None, device_class=None, mesh=None) -> None:
    ul, tr = _flag(_UPLO, uplo, "Uplo"), _flag(_TRANS, trans, "Trans")
    ar, ac = (n, k) if tr == "N" else (k, n)
    Av = _view(A, ar, ac, lda, order, "A", dtype=dtype)
    Cv = _view(C, n, n, ldc, order, "C", writable=True, dtype=dtype)
    # BLAS syrk always reads C's uplo triangle (beta scales it), so seed
    # the context call with Cv even for beta == 0 to preserve the
    # untouched opposite triangle in the writeback.
    c = _ctx(ctx, backend, device_class, mesh)
    out = c.syrk(Av, Cv, alpha=alpha, beta=beta, uplo=ul,
                 trans=tr, tile=tile, dtype=dtype)
    Cv[...] = out.array()


def _syr2k(dtype, order, uplo, trans, n, k, alpha, A, lda, B, ldb, beta,
           C, ldc, ctx, backend, tile=None, device_class=None,
           mesh=None) -> None:
    ul, tr = _flag(_UPLO, uplo, "Uplo"), _flag(_TRANS, trans, "Trans")
    ar, ac = (n, k) if tr == "N" else (k, n)
    Av = _view(A, ar, ac, lda, order, "A", dtype=dtype)
    Bv = _view(B, ar, ac, ldb, order, "B", dtype=dtype)
    Cv = _view(C, n, n, ldc, order, "C", writable=True, dtype=dtype)
    c = _ctx(ctx, backend, device_class, mesh)
    out = c.syr2k(Av, Bv, Cv, alpha=alpha, beta=beta,
                  uplo=ul, trans=tr, tile=tile,
                  dtype=dtype)
    Cv[...] = out.array()


def _trmm(dtype, order, side, uplo, transa, diag, m, n, alpha, A, lda,
          B, ldb, ctx, backend, tile=None, device_class=None,
          mesh=None) -> None:
    sd, ul = _flag(_SIDE, side, "Side"), _flag(_UPLO, uplo, "Uplo")
    ta, dg = _flag(_TRANS, transa, "Trans"), _flag(_DIAG, diag, "Diag")
    ka = m if sd == "L" else n
    Av = _view(A, ka, ka, lda, order, "A", dtype=dtype)
    Bv = _view(B, m, n, ldb, order, "B", writable=True, dtype=dtype)
    c = _ctx(ctx, backend, device_class, mesh)
    out = c.trmm(Av, Bv, alpha=alpha, side=sd, uplo=ul,
                 transa=ta, diag=dg, tile=tile,
                 dtype=dtype)
    Bv[...] = out.array()


def _trsm(dtype, order, side, uplo, transa, diag, m, n, alpha, A, lda,
          B, ldb, ctx, backend, tile=None, device_class=None,
          mesh=None) -> None:
    sd, ul = _flag(_SIDE, side, "Side"), _flag(_UPLO, uplo, "Uplo")
    ta, dg = _flag(_TRANS, transa, "Trans"), _flag(_DIAG, diag, "Diag")
    ka = m if sd == "L" else n
    Av = _view(A, ka, ka, lda, order, "A", dtype=dtype)
    Bv = _view(B, m, n, ldb, order, "B", writable=True, dtype=dtype)
    c = _ctx(ctx, backend, device_class, mesh)
    out = c.trsm(Av, Bv, alpha=alpha, side=sd, uplo=ul,
                 transa=ta, diag=dg, tile=tile,
                 dtype=dtype)
    Bv[...] = out.array()


# ================================================ double-precision surface
def cblas_dgemm(order, transa, transb, m: int, n: int, k: int,
                alpha: float, A, lda: int, B, ldb: int,
                beta: float, C, ldc: int, *,
                ctx: Optional[BlasxContext] = None,
                backend: Optional[str] = None,
                tile=None, device_class: Optional[str] = None,
                mesh: Optional[int] = None) -> None:
    """C := alpha*op(A)*op(B) + beta*C  (C is m x n, updated in place)."""
    _gemm(np.float64, order, transa, transb, m, n, k, alpha, A, lda,
          B, ldb, beta, C, ldc, ctx, backend, tile, device_class, mesh)


def cblas_dsymm(order, side, uplo, m: int, n: int, alpha: float,
                A, lda: int, B, ldb: int, beta: float, C, ldc: int, *,
                ctx: Optional[BlasxContext] = None,
                backend: Optional[str] = None,
                tile=None, device_class: Optional[str] = None,
                mesh: Optional[int] = None) -> None:
    """C := alpha*A*B + beta*C (Left) or alpha*B*A + beta*C (Right),
    A symmetric with the ``uplo`` triangle stored."""
    _symm(np.float64, order, side, uplo, m, n, alpha, A, lda, B, ldb,
          beta, C, ldc, ctx, backend, tile, device_class, mesh)


def cblas_dsyrk(order, uplo, trans, n: int, k: int, alpha: float,
                A, lda: int, beta: float, C, ldc: int, *,
                ctx: Optional[BlasxContext] = None,
                backend: Optional[str] = None,
                tile=None, device_class: Optional[str] = None,
                mesh: Optional[int] = None) -> None:
    """C := alpha*op(A)*op(A)^T + beta*C on the ``uplo`` triangle."""
    _syrk(np.float64, order, uplo, trans, n, k, alpha, A, lda, beta,
          C, ldc, ctx, backend, tile, device_class, mesh)


def cblas_dsyr2k(order, uplo, trans, n: int, k: int, alpha: float,
                 A, lda: int, B, ldb: int, beta: float, C, ldc: int, *,
                 ctx: Optional[BlasxContext] = None,
                 backend: Optional[str] = None,
                 tile=None, device_class: Optional[str] = None,
                 mesh: Optional[int] = None) -> None:
    """C := alpha*op(A)*op(B)^T + alpha*op(B)*op(A)^T + beta*C."""
    _syr2k(np.float64, order, uplo, trans, n, k, alpha, A, lda, B, ldb,
           beta, C, ldc, ctx, backend, tile, device_class, mesh)


def cblas_dtrmm(order, side, uplo, transa, diag, m: int, n: int,
                alpha: float, A, lda: int, B, ldb: int, *,
                ctx: Optional[BlasxContext] = None,
                backend: Optional[str] = None,
                tile=None, device_class: Optional[str] = None,
                mesh: Optional[int] = None) -> None:
    """B := alpha*op(tri(A))*B (Left) or alpha*B*op(tri(A)) (Right),
    B (m x n) updated in place."""
    _trmm(np.float64, order, side, uplo, transa, diag, m, n, alpha,
          A, lda, B, ldb, ctx, backend, tile, device_class, mesh)


def cblas_dtrsm(order, side, uplo, transa, diag, m: int, n: int,
                alpha: float, A, lda: int, B, ldb: int, *,
                ctx: Optional[BlasxContext] = None,
                backend: Optional[str] = None,
                tile=None, device_class: Optional[str] = None,
                mesh: Optional[int] = None) -> None:
    """Solve op(tri(A))*X = alpha*B (Left) or X*op(tri(A)) = alpha*B
    (Right); X overwrites B (m x n) in place."""
    _trsm(np.float64, order, side, uplo, transa, diag, m, n, alpha,
          A, lda, B, ldb, ctx, backend, tile, device_class, mesh)


# ================================================ single-precision surface
def cblas_sgemm(order, transa, transb, m: int, n: int, k: int,
                alpha: float, A, lda: int, B, ldb: int,
                beta: float, C, ldc: int, *,
                ctx: Optional[BlasxContext] = None,
                backend: Optional[str] = None,
                tile=None, device_class: Optional[str] = None,
                mesh: Optional[int] = None) -> None:
    """Single-precision GEMM: C := alpha*op(A)*op(B) + beta*C, all
    buffers float32, C updated in place."""
    _gemm(np.float32, order, transa, transb, m, n, k, alpha, A, lda,
          B, ldb, beta, C, ldc, ctx, backend, tile, device_class, mesh)


def cblas_ssymm(order, side, uplo, m: int, n: int, alpha: float,
                A, lda: int, B, ldb: int, beta: float, C, ldc: int, *,
                ctx: Optional[BlasxContext] = None,
                backend: Optional[str] = None,
                tile=None, device_class: Optional[str] = None,
                mesh: Optional[int] = None) -> None:
    """Single-precision SYMM (see :func:`cblas_dsymm`)."""
    _symm(np.float32, order, side, uplo, m, n, alpha, A, lda, B, ldb,
          beta, C, ldc, ctx, backend, tile, device_class, mesh)


def cblas_ssyrk(order, uplo, trans, n: int, k: int, alpha: float,
                A, lda: int, beta: float, C, ldc: int, *,
                ctx: Optional[BlasxContext] = None,
                backend: Optional[str] = None,
                tile=None, device_class: Optional[str] = None,
                mesh: Optional[int] = None) -> None:
    """Single-precision SYRK (see :func:`cblas_dsyrk`)."""
    _syrk(np.float32, order, uplo, trans, n, k, alpha, A, lda, beta,
          C, ldc, ctx, backend, tile, device_class, mesh)


def cblas_ssyr2k(order, uplo, trans, n: int, k: int, alpha: float,
                 A, lda: int, B, ldb: int, beta: float, C, ldc: int, *,
                 ctx: Optional[BlasxContext] = None,
                 backend: Optional[str] = None,
                 tile=None, device_class: Optional[str] = None,
                 mesh: Optional[int] = None) -> None:
    """Single-precision SYR2K (see :func:`cblas_dsyr2k`)."""
    _syr2k(np.float32, order, uplo, trans, n, k, alpha, A, lda, B, ldb,
           beta, C, ldc, ctx, backend, tile, device_class, mesh)


def cblas_strmm(order, side, uplo, transa, diag, m: int, n: int,
                alpha: float, A, lda: int, B, ldb: int, *,
                ctx: Optional[BlasxContext] = None,
                backend: Optional[str] = None,
                tile=None, device_class: Optional[str] = None,
                mesh: Optional[int] = None) -> None:
    """Single-precision TRMM (see :func:`cblas_dtrmm`)."""
    _trmm(np.float32, order, side, uplo, transa, diag, m, n, alpha,
          A, lda, B, ldb, ctx, backend, tile, device_class, mesh)


def cblas_strsm(order, side, uplo, transa, diag, m: int, n: int,
                alpha: float, A, lda: int, B, ldb: int, *,
                ctx: Optional[BlasxContext] = None,
                backend: Optional[str] = None,
                tile=None, device_class: Optional[str] = None,
                mesh: Optional[int] = None) -> None:
    """Single-precision TRSM (see :func:`cblas_dtrsm`)."""
    _trsm(np.float32, order, side, uplo, transa, diag, m, n, alpha,
          A, lda, B, ldb, ctx, backend, tile, device_class, mesh)
