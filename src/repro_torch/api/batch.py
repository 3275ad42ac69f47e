"""Batched GEMM for serving-shaped workloads (cuBLAS batched analogues).

Serving traffic is many small/medium GEMMs against shared weights
(per-layer projections, per-request adapters).  Both entry points run
every problem through ONE context, so shared operands — e.g. the same
weight handle across the whole batch — are fetched once and then served
from the warm tile caches.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .context import MatrixHandle, host_array


def gemm_batched(ctx, As: Sequence, Bs: Sequence,
                 Cs: Optional[Sequence] = None, *, alpha: float = 1.0,
                 beta: float = 0.0, transa: str = "N", transb: str = "N",
                 tile: Optional[int] = None, dtype=None) -> List:
    """Pointer-array batch: ``out[i] = alpha*op(As[i])@op(Bs[i]) +
    beta*Cs[i]``.

    ``As``/``Bs`` may mix host arrays and ``MatrixHandle``s; repeating
    one handle across the batch (shared weights) is the intended warm
    path.  ``dtype`` pins the batch's storage precision (same rules as
    ``ctx.gemm``).  ``tile="auto"`` resolves ONE tuned tile from the
    first entry's shape (via the runtime autotuner) and applies it to
    the whole batch — batch entries share tile keys, so they must
    share a tile size.  Returns a list of ``MatrixHandle``s.
    """
    if len(As) != len(Bs):
        raise ValueError(f"batch mismatch: {len(As)} A's vs {len(Bs)} B's")
    if Cs is not None and len(Cs) != len(As):
        raise ValueError(f"batch mismatch: {len(As)} A's vs {len(Cs)} C's")
    if tile == "auto":
        tile = _auto_batch_tile(ctx, As[0], Bs[0], transa, transb, dtype)
    # pre-register handles so every batch entry shares tile keys
    Ahs = [ctx.tile(a, tile, dtype=dtype) for a in As]
    Bhs = [ctx.tile(b, tile, dtype=dtype) for b in Bs]
    # synchronous loop, NOT ctx.submit per entry: the context serializes
    # execution on its lock anyway, and nesting submissions would
    # deadlock the single-worker executor when the batch itself was
    # submitted asynchronously (ctx.submit("gemm_batched", ...)).
    return [
        ctx.gemm(Ahs[i], Bhs[i], None if Cs is None else Cs[i],
                 alpha=alpha, beta=beta, transa=transa, transb=transb,
                 tile=tile, dtype=dtype)
        for i in range(len(As))
    ]


def _auto_batch_tile(ctx, a0, b0, transa: str, transb: str, dtype) -> int:
    """Resolve one tuned tile for a whole GEMM batch from its first
    entry's logical (m, k, n) — batched entries are same-shaped in the
    cuBLAS contract, and near-shaped entries land in the same tuning
    bucket anyway."""
    a_sh, b_sh = _shape(a0), _shape(b0)
    ta, tb = transa.upper()[0], transb.upper()[0]
    m, k = (a_sh[0], a_sh[1]) if ta == "N" else (a_sh[1], a_sh[0])
    n = b_sh[1] if tb == "N" else b_sh[0]
    return ctx.auto_tile("gemm", m, k, n, dtype=dtype)


def _shape(x):
    return tuple(x.shape) if hasattr(x, "shape") else np.asarray(x).shape


def gemm_strided_batched(ctx, A, B, C=None, *, alpha: float = 1.0,
                         beta: float = 0.0, transa: str = "N",
                         transb: str = "N",
                         tile: Optional[int] = None, dtype=None):
    """Strided batch over 3-D operands (batch axis first).

    A 2-D operand broadcasts across the batch (stride 0 — the shared
    weight matrix of an LM projection); its handle is registered once
    so all batch entries hit the same cached tiles.  Returns the
    stacked 3-D result (a numpy array; a CPU tensor for bfloat16).
    """
    def _entries(x):
        if isinstance(x, MatrixHandle) or len(_shape(x)) == 2:
            return None  # broadcast
        a = x if isinstance(x, torch.Tensor) else np.asarray(x)
        if a.ndim != 3:
            raise ValueError(f"strided batch operand must be 2-D or 3-D, "
                             f"got {tuple(a.shape)}")
        return a

    a3, b3 = _entries(A), _entries(B)
    c3 = None if C is None else _entries(C)
    sizes = {x.shape[0] for x in (a3, b3, c3) if x is not None}
    if len(sizes) > 1:
        raise ValueError(f"inconsistent batch sizes {sorted(sizes)}")
    if not sizes:
        raise ValueError("at least one operand must be 3-D")
    nb = sizes.pop()

    if tile == "auto":
        tile = _auto_batch_tile(ctx, A if a3 is None else a3[0],
                                B if b3 is None else b3[0],
                                transa, transb, dtype)
    # broadcast operands become one shared handle (stride-0 reuse)
    Ah = ctx.tile(A, tile, dtype=dtype) if a3 is None else None
    Bh = ctx.tile(B, tile, dtype=dtype) if b3 is None else None
    outs = gemm_batched(
        ctx,
        [Ah if a3 is None else a3[i] for i in range(nb)],
        [Bh if b3 is None else b3[i] for i in range(nb)],
        None if C is None else [C if c3 is None else c3[i]
                                for i in range(nb)],
        alpha=alpha, beta=beta, transa=transa, transb=transb, tile=tile,
        dtype=dtype)
    return host_array(torch.stack([o.tiled.data for o in outs]))
