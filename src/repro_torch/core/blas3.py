"""Legacy array-in/array-out level-3 BLAS API (paper §III/§IV).

This is the compatibility surface of the two-layer API design: each of
the six L3 routines is a thin wrapper over a persistent
``repro_torch.api.BlasxContext``.  By default calls go through one
module-cached context (``repro_torch.api.default_context()``), on the
card, so the
runtime and its ALRU/MESI-X tile caches are built once per process —
not per call.  ``config=`` runs a call on a fresh, private runtime;
``runtime=`` adopts an existing one (ledgers accumulate on it).

``side='R'`` cases reduce to the native left-side tile algorithms via
the transpose identities (op(A)^T X^T = alpha B^T), mirroring the
paper's §III-C trick at matrix granularity — the reduction happens
inside the context methods.

``tile=`` is an int (default 256) or ``"auto"``, which resolves the
tile through the runtime autotuner (``repro_torch.tuning``) for the
call's routine, shape and dtype.

Every routine also has a ``ref_*`` oracle — plain PyTorch in float64,
on the CPU for arrays and on their own device for tensors — used by the
test suite and ``chip_smoke.py``.  For handle-based chaining use
``repro_torch.api`` directly.

Results are what ``MatrixHandle.array()`` returns: a numpy array for
float64/float32/float16, the CPU tensor for bfloat16 (numpy has no
bfloat16).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import task as taskmod
from .runtime import BlasxRuntime, RuntimeConfig

DEFAULT_TILE = 256


def _finish(out):
    """Extract the result array and drop the discarded output handle's
    cached tiles (TRSM/TRMM chains cache output tiles as step inputs;
    legacy callers never reuse the handle, so they'd be dead weight)."""
    data = out.array()
    out.invalidate()
    return data


def _context(config: Optional[RuntimeConfig],
             runtime: Optional[BlasxRuntime],
             backend: Optional[str] = None,
             device_class: Optional[str] = None,
             mesh: Optional[int] = None):
    """Resolve the executing context for one legacy call.

    ``backend`` selects the execution backend (torch | cuda)
    for this call; with ``runtime=`` it must match the runtime's own.
    ``device_class``/``mesh`` select the pod tier (a private context is
    built for the call — they cannot be combined with ``runtime=``).

    Imported lazily: ``repro_torch.api`` depends on core modules,
    so the dependency must point api -> core at import time."""
    from ..api.context import (BlasxContext, backend_context,
                               default_context)

    if device_class is not None or mesh is not None:
        return BlasxContext(config, backend=backend, runtime=runtime,
                            device_class=device_class, mesh=mesh)
    if runtime is not None:
        return BlasxContext(runtime=runtime, backend=backend)
    if config is not None:
        return BlasxContext(config, backend=backend)
    if backend is not None:
        # module-cached warm context per backend (mirrors the default)
        return backend_context(backend)
    return default_context()


# ============================================================== GEMM (1a)
def gemm(A, B, C=None, *, alpha=1.0, beta=0.0, transa="N", transb="N",
         tile=DEFAULT_TILE, config: Optional[RuntimeConfig] = None,
         runtime: Optional[BlasxRuntime] = None,
         backend: Optional[str] = None, dtype=None,
         device_class: Optional[str] = None,
         mesh: Optional[int] = None):
    ctx = _context(config, runtime, backend, device_class, mesh)
    return _finish(ctx.gemm(A, B, C, alpha=alpha, beta=beta,
                            transa=transa, transb=transb, tile=tile,
                            dtype=dtype))


# ============================================================== SYRK (1b)
def syrk(A, C=None, *, alpha=1.0, beta=0.0, uplo="U", trans="N",
         tile=DEFAULT_TILE, config: Optional[RuntimeConfig] = None,
         runtime: Optional[BlasxRuntime] = None,
         backend: Optional[str] = None, dtype=None,
         device_class: Optional[str] = None,
         mesh: Optional[int] = None):
    ctx = _context(config, runtime, backend, device_class, mesh)
    return _finish(ctx.syrk(A, C, alpha=alpha, beta=beta, uplo=uplo,
                            trans=trans, tile=tile, dtype=dtype))


# ============================================================= SYR2K (1e)
def syr2k(A, B, C=None, *, alpha=1.0, beta=0.0, uplo="U", trans="N",
          tile=DEFAULT_TILE, config: Optional[RuntimeConfig] = None,
          runtime: Optional[BlasxRuntime] = None,
          backend: Optional[str] = None, dtype=None,
          device_class: Optional[str] = None,
          mesh: Optional[int] = None):
    ctx = _context(config, runtime, backend, device_class, mesh)
    return _finish(ctx.syr2k(A, B, C, alpha=alpha, beta=beta, uplo=uplo,
                             trans=trans, tile=tile, dtype=dtype))


# ============================================================== SYMM (1f)
def symm(A, B, C=None, *, alpha=1.0, beta=0.0, side="L", uplo="U",
         tile=DEFAULT_TILE, config: Optional[RuntimeConfig] = None,
         runtime: Optional[BlasxRuntime] = None,
         backend: Optional[str] = None, dtype=None,
         device_class: Optional[str] = None,
         mesh: Optional[int] = None):
    ctx = _context(config, runtime, backend, device_class, mesh)
    return _finish(ctx.symm(A, B, C, alpha=alpha, beta=beta, side=side,
                            uplo=uplo, tile=tile, dtype=dtype))


# ============================================================== TRMM (1d)
def trmm(A, B, *, alpha=1.0, side="L", uplo="U", transa="N", diag="N",
         tile=DEFAULT_TILE, config: Optional[RuntimeConfig] = None,
         runtime: Optional[BlasxRuntime] = None,
         backend: Optional[str] = None, dtype=None,
         device_class: Optional[str] = None,
         mesh: Optional[int] = None):
    ctx = _context(config, runtime, backend, device_class, mesh)
    return _finish(ctx.trmm(A, B, alpha=alpha, side=side, uplo=uplo,
                            transa=transa, diag=diag, tile=tile,
                            dtype=dtype))


# ============================================================== TRSM (1c)
def trsm(A, B, *, alpha=1.0, side="L", uplo="U", transa="N", diag="N",
         tile=DEFAULT_TILE, config: Optional[RuntimeConfig] = None,
         runtime: Optional[BlasxRuntime] = None,
         backend: Optional[str] = None, dtype=None,
         device_class: Optional[str] = None,
         mesh: Optional[int] = None):
    ctx = _context(config, runtime, backend, device_class, mesh)
    return _finish(ctx.trsm(A, B, alpha=alpha, side=side, uplo=uplo,
                            transa=transa, diag=diag, tile=tile,
                            dtype=dtype))


# ==================================================== paper-scale shadows
def shadow_run(routine: str, n: int, *, tile: int,
               runtime: BlasxRuntime, k: Optional[int] = None,
               uplo: str = "U", beta: float = 1.0,
               dtype="float64") -> BlasxRuntime:
    """Metadata-only run of one L3 routine on square N (A/B/C all NxN,
    SYRK/SYR2K inner dim ``k`` or N).  Requires a runtime configured
    with ``execute=False``.  ``dtype`` sets the storage precision the
    byte accounting models.  Returns the runtime (ledgers populated)."""
    from .dtypes import canonical_dtype
    from .tiling import ShadowMatrix

    if runtime.cfg.execute:
        raise ValueError("shadow_run needs RuntimeConfig(execute=False)")
    dt = canonical_dtype(dtype)
    k = k or n
    mats = {
        "A": ShadowMatrix("A", n, k if routine in ("syrk", "syr2k") else n,
                          tile, dtype=dt),
        "B": ShadowMatrix("B", n, k if routine == "syr2k" else n, tile,
                          dtype=dt),
        "Cin": ShadowMatrix("Cin", n, n, tile, dtype=dt),
        "C": ShadowMatrix("C", n, n, tile, dtype=dt),
    }
    g = {m.matrix_id: m.grid for m in mats.values()}
    if routine == "gemm":
        tasks = taskmod.taskize_gemm(g["A"], g["B"], g["C"], "N", "N",
                                     1.0, beta)
    elif routine == "syrk":
        tasks = taskmod.taskize_syrk(g["A"], g["C"], uplo, "N", 1.0, beta)
    elif routine == "syr2k":
        tasks = taskmod.taskize_syr2k(g["A"], g["B"], g["C"], uplo, "N",
                                      1.0, beta)
    elif routine == "symm":
        tasks = taskmod.taskize_symm(g["A"], g["B"], g["C"], uplo, 1.0, beta)
    elif routine == "trmm":
        tasks = taskmod.taskize_trmm(g["A"], g["Cin"], g["C"], uplo, "N",
                                     "N", 1.0)
    elif routine == "trsm":
        tasks = taskmod.taskize_trsm(g["A"], g["B"], g["C"], uplo, "N",
                                     "N", 1.0)
    else:
        raise ValueError(routine)
    runtime.run(tasks, mats, "C")
    return runtime


# ====================================================== reference oracles
def _f64(x) -> torch.Tensor:
    """A float64 tensor of an array (on the CPU) or of a tensor (on its
    own device, so an oracle over card tensors runs on the card)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64)
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def ref_gemm(A, B, C=None, *, alpha=1.0, beta=0.0, transa="N", transb="N"):
    A, B = _f64(A), _f64(B)
    opa = A if transa.upper()[0] == "N" else A.T
    opb = B if transb.upper()[0] == "N" else B.T
    out = alpha * (opa @ opb)
    if C is not None and beta != 0.0:
        out = out + beta * _f64(C)
    return out


def _sym(A, uplo):
    if uplo.upper()[0] == "U":
        return torch.triu(A) + torch.triu(A, 1).T
    return torch.tril(A) + torch.tril(A, -1).T


def _tri(A, uplo, diag):
    t = torch.triu(A) if uplo.upper()[0] == "U" else torch.tril(A)
    if diag.upper()[0] == "U":
        t.diagonal().fill_(1.0)
    return t


def _uplo_update(full, C, beta, uplo):
    """BLAS triangle semantics shared by SYRK/SYR2K: write
    ``full + beta*C`` into the ``uplo`` triangle, keep the original C
    (or zeros) elsewhere."""
    n = full.shape[0]
    c = torch.zeros_like(full) if C is None else _f64(C).to(full.device)
    base = torch.zeros_like(c) if C is None else beta * c
    ones = torch.ones((n, n), dtype=torch.bool, device=full.device)
    mask = torch.triu(ones) if uplo.upper()[0] == "U" else torch.tril(ones)
    return torch.where(mask, full + base, c)


def ref_syrk(A, C=None, *, alpha=1.0, beta=0.0, uplo="U", trans="N"):
    A = _f64(A)
    full = alpha * (A @ A.T if trans.upper()[0] == "N" else A.T @ A)
    return _uplo_update(full, C, beta, uplo)


def ref_syr2k(A, B, C=None, *, alpha=1.0, beta=0.0, uplo="U", trans="N"):
    A, B = _f64(A), _f64(B)
    if trans.upper()[0] == "N":
        full = alpha * (A @ B.T) + alpha * (B @ A.T)
    else:
        full = alpha * (A.T @ B) + alpha * (B.T @ A)
    return _uplo_update(full, C, beta, uplo)


def ref_symm(A, B, C=None, *, alpha=1.0, beta=0.0, side="L", uplo="U"):
    sa, B = _sym(_f64(A), uplo), _f64(B)
    prod = sa @ B if side.upper()[0] == "L" else B @ sa
    out = alpha * prod
    if C is not None and beta != 0.0:
        out = out + beta * _f64(C)
    return out


def ref_trmm(A, B, *, alpha=1.0, side="L", uplo="U", transa="N", diag="N"):
    ta, B = _tri(_f64(A), uplo, diag), _f64(B)
    opa = ta if transa.upper()[0] == "N" else ta.T
    return alpha * (opa @ B if side.upper()[0] == "L" else B @ opa)


def ref_trsm(A, B, *, alpha=1.0, side="L", uplo="U", transa="N", diag="N"):
    ta, B = _tri(_f64(A), uplo, diag), _f64(B)
    opa = ta if transa.upper()[0] == "N" else ta.T
    if side.upper()[0] == "L":
        return torch.linalg.solve(opa, alpha * B)
    return torch.linalg.solve(opa.T, alpha * B.T).T
