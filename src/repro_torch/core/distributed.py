"""Distributed tiled GEMM over ``torch.distributed`` — BLASX's insights
on a ring of ranks.

The counterpart of the reference's ``core/distributed.py``, whose
kernels are ``shard_map`` bodies over a named mesh axis.  Here each
rank is one eager process, and a mesh axis is a ``ProcessGroup``
(``DeviceMesh.get_group(axis)``):

* **L2 tile cache / P2P**: in the ring schedules below, after the first
  step every operand panel a rank consumes arrives from its ring
  *neighbour* (a ``batch_isend_irecv`` hop), never from a distant shard
  or the host.

* **4-stream overlap**: each ring step posts the hop of the *next*
  panel before it multiplies the current one and waits for the hop
  after, so the transfer runs under the matmul.

* **Locality-first scheduling (Eq. 3)**: every rank starts with the
  panel it already holds before touching remote panels.

The shard-level functions take this rank's local shards and a group:

  ``ring_allgather_matmul``      Y[m, n/d] = allgather_m(X[m/d, k]) @ W[k, n/d]
  ``ring_reduce_scatter_matmul`` Y[m/d, n] = reduce-scatter_m(X[m, k/d] @ W[k/d, n])

each with a ``gspmd_*`` twin built on the library collectives.
``distributed_gemm`` and ``tp_matmul`` take the full operands on every
rank, compute on this rank's shards in the reference's layouts and
return the full result on every rank.

Every collective a call issues is counted in :data:`COLLECTIVES` (P2P
hops, all-gathers, reduce-scatters, all-reduces), so a test can see
what a schedule lowers to.  The local products are ``torch.matmul``,
as the reference's are ``jnp.dot``: no Pallas kernel runs there.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

# collectives issued since the last reset, by kind; "p2p" counts ring
# hops (one send and one receive a rank)
COLLECTIVES = {"p2p": 0, "all_gather": 0, "reduce_scatter": 0,
               "all_reduce": 0}


def reset_collectives() -> None:
    for kind in COLLECTIVES:
        COLLECTIVES[kind] = 0


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (the reference's
    ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _acc_type(a_dtype: torch.dtype, b_dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: at least f32, widened to f64 when either
    operand is 64-bit."""
    return torch.promote_types(torch.float32,
                               torch.promote_types(a_dtype, b_dtype))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in the accumulation dtype (the reference's
    ``preferred_element_type``): the operands are widened to it, which
    is exact, so the products are the stored values'."""
    acc = _acc_type(a.dtype, b.dtype)
    return torch.matmul(a.to(acc), b.to(acc))


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if rows == x.shape[0]:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[0]))


# ------------------------------------------------------------ collectives
def _hop(send: torch.Tensor, group) -> tuple:
    """Post one ring hop: ``send`` to the next rank of ``group``, a
    buffer of its shape from the previous one.  Returns (buffer,
    requests); the buffer is valid after every request's ``wait``."""
    d, idx = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % d)
    prv = dist.get_global_rank(group, (idx - 1) % d)
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send.contiguous(), nxt, group),
        dist.P2POp(dist.irecv, recv, prv, group)])
    COLLECTIVES["p2p"] += 1
    return recv, reqs


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (the
    reference's tiled ``lax.all_gather``)."""
    d = dist.get_world_size(group)
    out = x.new_empty((d * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    if dim == 0:
        return out
    return torch.cat(out.chunk(d, dim=0), dim=dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of the ranks' ``x``, in ``x``'s dtype (``lax.psum``)."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    COLLECTIVES["all_reduce"] += 1
    return out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    d = dist.get_world_size(group)
    out = x.new_empty((x.shape[0] // d,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    COLLECTIVES["reduce_scatter"] += 1
    return out


class _Psum(torch.autograd.Function):
    """All-reduce forward, identity backward: the exit of a sharded
    region whose result every rank then uses alike."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Replicated(torch.autograd.Function):
    """Identity forward, all-reduced gradient backward: the entry of a
    sharded region.  Each rank's part of the gradient comes from its
    shard alone, so the sum is the whole gradient, on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of the ranks' partial ``x`` (differentiable)."""
    return _Psum.apply(x, group)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, held alike by every rank of ``group``, entering a region
    where each rank uses its own shard of it (differentiable)."""
    return _Replicated.apply(x, group)


# --------------------------------------------------------------------------
# shard-level bodies (take a process group; composable in larger programs)
# --------------------------------------------------------------------------
def ring_allgather_matmul(x_local: torch.Tensor, w_local: torch.Tensor,
                          group) -> torch.Tensor:
    """Y_local[m, n/d] = (all-gather of X over ``group``) @ W_local.

    X arrives row-sharded (m/d rows a rank); W is column-sharded.
    Panels circulate the ring and each rank multiplies the panel it
    currently holds: panel s+1's hop is posted before panel s's matmul
    and waited for after it.
    """
    d, idx = dist.get_world_size(group), dist.get_rank(group)
    m_local = x_local.shape[0]
    out_dtype = torch.promote_types(x_local.dtype, w_local.dtype)
    y = x_local.new_empty((d * m_local, w_local.shape[1]), dtype=out_dtype)
    # W is widened once, not once a panel
    w_acc = w_local.to(_acc_type(x_local.dtype, w_local.dtype))
    chunk = x_local
    for s in range(d):
        nxt = reqs = None
        if s < d - 1:
            nxt, reqs = _hop(chunk, group)
        # the panel in hand originated at rank (idx - s) mod d
        slot = (idx - s) % d
        y[slot * m_local:(slot + 1) * m_local] = _dot(chunk, w_acc)
        if reqs is not None:
            for r in reqs:
                r.wait()
            chunk = nxt
    return y


def ring_reduce_scatter_matmul(x_local: torch.Tensor, w_local: torch.Tensor,
                               group) -> torch.Tensor:
    """Y_local[m/d, n] = reduce-scatter_m(X_local[m, k/d] @ W_local[k/d, n]).

    Row-parallel: every rank holds a K-shard; the (m, n) partial
    products are reduce-scattered over rows by a ring in which the
    accumulator's hop overlaps the *next* row-block's matmul.

    Ragged row counts (``m % d != 0``) are padded with zero rows up to
    the next ring multiple, so the returned shard is ``ceil(m/d)`` rows
    and the gathered output has ``d*ceil(m/d)`` rows whose tail is
    zeros; callers slice (``tp_matmul`` / ``distributed_gemm`` do).
    """
    d, idx = dist.get_world_size(group), dist.get_rank(group)
    mb = -(-x_local.shape[0] // d)
    out_dtype = torch.promote_types(x_local.dtype, w_local.dtype)
    # both operands are widened once, not once a block
    acc_dtype = _acc_type(x_local.dtype, w_local.dtype)
    x_acc = _pad_rows(x_local, mb * d).to(acc_dtype)
    w_acc = w_local.to(acc_dtype)

    def block(b):
        return torch.matmul(x_acc[b * mb:(b + 1) * mb], w_acc)

    # start with the block that travels the whole ring (locality-first:
    # it is computed from the panel already on this rank)
    acc = block((idx - 1) % d)
    for s in range(1, d):
        moved, reqs = _hop(acc, group)
        part = block((idx - 1 - s) % d)   # overlap: matmul vs hop
        for r in reqs:
            r.wait()
        acc = moved + part
    return acc.to(out_dtype)


# ------------------------------------------------------- gspmd baselines
def gspmd_allgather_matmul(x_local, w_local, group):
    x_full = all_gather(x_local, group)
    return _dot(x_full, w_local).to(
        torch.promote_types(x_local.dtype, w_local.dtype))


def gspmd_reduce_scatter_matmul(x_local, w_local, group):
    d = dist.get_world_size(group)
    # same pad-and-slice contract as the ring twin
    x_local = _pad_rows(x_local, -(-x_local.shape[0] // d) * d)
    out = _reduce_scatter(_dot(x_local, w_local), group)
    return out.to(torch.promote_types(x_local.dtype, w_local.dtype))


MODES = {
    "ring": (ring_allgather_matmul, ring_reduce_scatter_matmul),
    "gspmd": (gspmd_allgather_matmul, gspmd_reduce_scatter_matmul),
}


# --------------------------------------------------------------------------
# High-level: out-of-core GEMM over a mesh (the BLAS library on a pod)
# --------------------------------------------------------------------------
def distributed_gemm(A: torch.Tensor, B: torch.Tensor, mesh, *,
                     row_axis: str = "data", col_axis: str = "model",
                     mode: str = "ring") -> torch.Tensor:
    """C = A @ B on a 2-D ``DeviceMesh``; every rank passes the full A
    and B and gets the full C.

    Layout (the tile-algebra layout of §III at shard granularity):
      A : (row_axis, col_axis)   — both dims sharded
      B : (col_axis, None)       — K-sharded
      C : (row_axis, None)       — row-sharded, then gathered

    Every row group runs an independent K-reduction over ``col_axis``;
    with ``mode='ring'`` that reduction is the ring reduce-scatter GEMM
    above, re-gathered over ``col_axis``.  Ragged shapes (M not
    divisible by the row axis, K not by the column axis, or a row shard
    not by the ring) are padded with zeros and the result sliced back to
    ``(M, N)``.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}")
    shape = mesh_shape(mesh)
    dr, dc = shape[row_axis], shape[col_axis]
    r, c = mesh.get_local_rank(row_axis), mesh.get_local_rank(col_axis)
    rows, cols = mesh.get_group(row_axis), mesh.get_group(col_axis)
    m, k = A.shape
    mr, kc = -(-m // dr), -(-k // dc)
    A = torch.nn.functional.pad(A, (0, kc * dc - k, 0, mr * dr - m))
    B = _pad_rows(B, kc * dc)
    a_blk = A[r * mr:(r + 1) * mr, c * kc:(c + 1) * kc]
    b_blk = B[c * kc:(c + 1) * kc]
    if mode == "ring":
        y = ring_reduce_scatter_matmul(a_blk, b_blk, cols)
        # the ring pads ragged row shards up to the next ring multiple
        y = all_gather(y, cols)[:mr]
    else:
        y = all_reduce(_dot(a_blk, b_blk), cols).to(
            torch.promote_types(a_blk.dtype, b_blk.dtype))
    return all_gather(y, rows)[:m]


def tp_matmul(x: torch.Tensor, w: torch.Tensor, mesh, *, axis: str = "model",
              kind: str = "column", mode: str = "ring",
              batch_axis: Optional[str] = "data") -> torch.Tensor:
    """Tensor-parallel projection; every rank passes the full x (B, S, F)
    and w and gets the full result.

    kind='column': x is sequence-sharded on ``axis``, W column-sharded;
                   the activations come out column-sharded.
    kind='row'   : x is feature-sharded on ``axis``, W row-sharded; the
                   activations come out sequence-sharded on ``axis``.

    The batch dim is sharded on ``batch_axis`` (None: replicated).  A
    sequence length not divisible by the ``axis`` ring is padded with
    zeros up to the next multiple and the result sliced back.  Rows are
    gathered and scattered sequence by sequence, so a local batch of
    several sequences keeps each sequence's rows together.
    """
    ag, rs = MODES[mode]
    if kind not in ("column", "row"):
        raise ValueError(f"kind must be column|row, got {kind}")
    shape = mesh_shape(mesh)
    d, j = shape[axis], mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    bsz, s = x.shape[0], x.shape[1]
    db = shape[batch_axis] if batch_axis else 1
    if bsz % db:
        raise ValueError(f"batch {bsz} not divisible by the {batch_axis!r} "
                         f"axis of size {db}")
    bl = bsz // db
    bi = mesh.get_local_rank(batch_axis) if batch_axis else 0
    sp = -(-s // d) * d
    sl = sp // d
    x = torch.nn.functional.pad(x, (0, 0, 0, sp - s))[bi * bl:(bi + 1) * bl]
    if kind == "column":
        nl = w.shape[1] // d
        xl = x[:, j * sl:(j + 1) * sl].reshape(bl * sl, -1)
        y = ag(xl, w[:, j * nl:(j + 1) * nl], group)      # (d*bl*sl, nl)
        y = y.reshape(d, bl, sl, nl).transpose(0, 1).reshape(bl, sp, nl)
        y = all_gather(y, group, dim=2)                    # (bl, sp, N)
    else:
        fl = w.shape[0] // d
        xl = x[..., j * fl:(j + 1) * fl]
        # rows ordered (sequence block, batch, position): the scatter
        # hands rank i sequence block i of every local sequence
        x2 = xl.reshape(bl, d, sl, fl).transpose(0, 1).reshape(d * bl * sl, fl)
        y = rs(x2, w[j * fl:(j + 1) * fl], group).reshape(bl, sl, -1)
        y = all_gather(y, group, dim=1)                    # (bl, sp, N)
    if batch_axis:
        y = all_gather(y, mesh.get_group(batch_axis))
    return y[:, :s]
