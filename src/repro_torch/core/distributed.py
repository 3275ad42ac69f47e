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

* **Slab pipeline**: ``distributed_gemm``'s ring splits a large row
  group into slabs, each reduce-scattered by the ring in turn and then
  all-gathered straight into its rows of the output while the next
  slab's products run; only the last slab's last hop and gather are
  left uncovered (:func:`_slabs` picks the count from the shape).

The shard-level functions take this rank's local shards and a group:

  ``ring_allgather_matmul``      Y[m, n/d] = allgather_m(X[m/d, k]) @ W[k, n/d]
  ``ring_reduce_scatter_matmul`` Y[m/d, n] = reduce-scatter_m(X[m, k/d] @ W[k/d, n])

each with a ``gspmd_*`` twin built on the library collectives.
``distributed_gemm`` and ``tp_matmul`` take the full operands on every
rank, compute on this rank's shards in the reference's layouts and
return the full result on every rank.

Every collective a call issues is counted in :data:`COLLECTIVES` (P2P
hops, all-gathers, reduce-scatters, all-reduces), so a test can see
what a schedule lowers to, and its operand bytes are added to
:data:`COLLECTIVE_BYTES` under the reference's HLO kind names (the
dry-run's collective term, ``launch/roofline.py``); both are also kept
by mesh axis (:data:`COLLECTIVES_BY_AXIS`, :data:`COLLECTIVE_BYTES_BY_AXIS`)
for the groups taken through :func:`axis_group`.  Beside them,
:data:`PREP_BYTES` counts the bytes of the new tensors the GEMM's
operand prep makes (padding, widening), and :data:`RING_SLABS` the
slabs ``distributed_gemm``'s ring ran.  The ring GEMM's phases are
named spans under a torch profiler (``core/spans.py``).

The model stack's tensor-parallel pieces are here too: the Megatron
pair :func:`replicated` / :func:`psum`, and the vocab-parallel
embedding lookup and cross-entropy over a vocab-sharded table or
logits (:func:`vocab_parallel_embed`, :func:`vocab_parallel_ce`).  The local products are ``torch.matmul``,
as the reference's are ``jnp.dot``: no Pallas kernel runs there.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .spans import span

# collectives issued since the last reset, by kind; "p2p" counts ring
# hops (one send and one receive a rank)
COLLECTIVES = {"p2p": 0, "all_gather": 0, "reduce_scatter": 0,
               "all_reduce": 0}
# operand bytes of those collectives since the last reset, by the
# reference's HLO kind (its roofline.COLLECTIVE_OPS; a ring hop is a
# collective-permute): what one rank sends into each call, the
# reference's convention for its collective term
COLLECTIVE_BYTES = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
                    "all-to-all": 0, "collective-permute": 0}


# bytes of the new tensors operand prep made since the last reset (a
# pad or a widening; an operand prep hands on as it is counts nothing);
# read it as ``distributed.PREP_BYTES``
PREP_BYTES = 0

# row slabs distributed_gemm's ring ran since the last reset (one a call
# where the shape gives no more); read it as ``distributed.RING_SLABS``
RING_SLABS = 0

# distributed_gemm's ring splits a row group into the most of _SLABS
# slabs that keeps every product at least _SLAB_ROWS rows: on four
# H100s at N 16384, 2 slabs of 2048-row products ran fastest, ahead of
# 4 (1024 rows), 8 (512) and 1
_SLABS = (4, 2, 1)
_SLAB_ROWS = 2048


# the same by mesh axis ({axis: {kind: n}}, {axis: {hlo kind: bytes}}):
# a group taken through axis_group counts under its axis' name, any
# other under "other"
COLLECTIVES_BY_AXIS: dict = {}
COLLECTIVE_BYTES_BY_AXIS: dict = {}
# id(group) -> (group, axis name), filled by axis_group (the group is
# kept so that its id is never reused by another)
_AXIS_OF: dict = {}


def reset_collectives() -> None:
    global PREP_BYTES, RING_SLABS
    PREP_BYTES = RING_SLABS = 0
    for kind in COLLECTIVES:
        COLLECTIVES[kind] = 0
    for kind in COLLECTIVE_BYTES:
        COLLECTIVE_BYTES[kind] = 0
    COLLECTIVES_BY_AXIS.clear()
    COLLECTIVE_BYTES_BY_AXIS.clear()


def axis_group(mesh, name: str):
    """The process group of ``mesh``'s axis ``name``, remembered as that
    axis' so that its collectives are counted by axis."""
    group = mesh.get_group(name)
    _AXIS_OF[id(group)] = (group, name)
    return group


def _count(kind: str, hlo_kind: str, operand: torch.Tensor,
           group=None) -> None:
    n = operand.numel() * operand.element_size()
    COLLECTIVES[kind] += 1
    COLLECTIVE_BYTES[hlo_kind] += n
    axis = _AXIS_OF.get(id(group), (None, "other"))[1]
    counts = COLLECTIVES_BY_AXIS.setdefault(axis, {})
    counts[kind] = counts.get(kind, 0) + 1
    nbytes = COLLECTIVE_BYTES_BY_AXIS.setdefault(axis, {})
    nbytes[hlo_kind] = nbytes.get(hlo_kind, 0) + n


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (the reference's
    ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


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


def _prepped(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new``, which operand prep made from ``old``: its bytes are
    added to :data:`PREP_BYTES` unless it is ``old`` itself."""
    global PREP_BYTES
    if new is not old:
        PREP_BYTES += new.numel() * new.element_size()
    return new


# ------------------------------------------------------------ collectives
def _hop(send: torch.Tensor, group) -> tuple:
    """Post one ring hop: ``send`` to the next rank of ``group``, a
    buffer of its shape from the previous one.  Returns (buffer,
    requests); the buffer is valid after every request's ``wait``."""
    d, idx = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % d)
    prv = dist.get_global_rank(group, (idx - 1) % d)
    with span("blasx.ring.hop"):
        recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, recv, prv, group)])
    _count("p2p", "collective-permute", send, group)
    return recv, reqs


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (the
    reference's tiled ``lax.all_gather``)."""
    d = dist.get_world_size(group)
    out = x.new_empty((d * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    _count("all_gather", "all-gather", x, group)
    if dim == 0:
        return out
    return torch.cat(out.chunk(d, dim=0), dim=dim)


def _gather_into(out: torch.Tensor, x: torch.Tensor, group):
    """Post the all-gather of the ranks' contiguous ``x`` into ``out``,
    contiguous and ``d`` times ``x``'s rows, in rank order.  Returns
    its request; ``out`` is valid after its ``wait``."""
    work = dist.all_gather_into_tensor(out, x, group=group, async_op=True)
    _count("all_gather", "all-gather", x, group)
    return work


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum (or, with ``op="max"``, maximum) of the ranks' ``x``, in
    ``x``'s dtype (``lax.psum`` / ``lax.pmax``)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    _count("all_reduce", "all-reduce", x, group)
    return out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    d = dist.get_world_size(group)
    out = x.new_empty((x.shape[0] // d,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    _count("reduce_scatter", "reduce-scatter", x, group)
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


class _SharedSum(torch.autograd.Function):
    """All-reduce forward and backward: a sum of the ranks' partials
    that every rank's loss then uses, so each partial's gradient is the
    sum of all the ranks' gradients of the total."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of the ranks' ``x``."""
    if dim == 0:
        return _reduce_scatter(x, group)
    return _reduce_scatter(x.movedim(dim, 0), group).movedim(0, dim
                                                              ).contiguous()


class _GatherShards(torch.autograd.Function):
    """All-gather forward along ``dim``: the whole of a leaf stored in
    shards.  Backward, this rank's block of the gradient: summed over
    the ranks (a reduce-scatter) where each rank's gradient is a part of
    the whole (``summed``: the ranks hold different slices of the
    batch), else its own block of a gradient every rank holds alike."""

    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.summed:
            return reduce_scatter(grad, ctx.group, ctx.dim), None, None, None
        n, i = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return (grad.chunk(n, ctx.dim)[i].contiguous(), None, None, None)


def gather_shards(x: torch.Tensor, group, dim: int, summed: bool
                  ) -> torch.Tensor:
    """``x``'s shards over ``group`` joined along ``dim``
    (differentiable; see :class:`_GatherShards` for the gradient)."""
    return _GatherShards.apply(x, group, dim, summed)


def shared_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of the ranks' partial ``x``, used alike by every rank's loss
    (differentiable: a data-parallel statistic over the global batch)."""
    return _SharedSum.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of the ranks' partial ``x`` (differentiable)."""
    return _Psum.apply(x, group)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, held alike by every rank of ``group``, entering a region
    where each rank uses its own shard of it (differentiable)."""
    return _Replicated.apply(x, group)


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor, group,
                         start: int) -> torch.Tensor:
    """Rows ``tokens`` of an embedding table whose vocab is split over
    ``group``: ``table`` is this rank's rows ``start`` .. ``start +
    len(table)``; a token outside them gives zeros here, and the sum
    over the group (one all-reduce; exactly one rank adds a nonzero row)
    is the lookup.  Differentiable: each rank's rows get the gradient
    of the tokens it holds."""
    local = tokens.long() - start
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    return psum(rows, group)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token cross-entropy ``logsumexp(z) - z[label]`` over logits
    whose vocab is split over ``group`` (this rank's columns ``start``
    ..): the row maximum is all-reduced (max), then the sum of
    exponents and the label's logit, taken from the rank that holds it,
    in one all-reduce.  Backward, this rank's block of ``softmax -
    onehot``."""

    @staticmethod
    def forward(ctx, logits, labels, group, start):
        vl = logits.shape[-1]
        m = all_reduce(logits.detach().amax(-1), group, op="max")
        e = torch.exp(logits - m[..., None])
        local = labels.long() - start
        inside = (local >= 0) & (local < vl)
        idx = local.clamp(0, vl - 1)
        picked = torch.where(inside, logits.gather(-1, idx[..., None])[..., 0],
                             logits.new_zeros(()))
        sums = all_reduce(torch.stack([e.sum(-1), picked]), group)
        ctx.save_for_backward(e, sums[0], idx, inside)
        return m + torch.log(sums[0]) - sums[1]

    @staticmethod
    def backward(ctx, grad):
        e, total, idx, inside = ctx.saved_tensors
        d = e / total[..., None]
        d.scatter_add_(-1, idx[..., None], -inside.to(d.dtype)[..., None])
        return d * grad[..., None], None, None, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, group,
                      start: int) -> torch.Tensor:
    """Per-token cross-entropy (the shape of ``labels``) of logits split
    over ``group`` by vocab, this rank's columns from ``start``
    (differentiable in ``logits``)."""
    return _VocabParallelCE.apply(logits, labels, group, start)


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
        with span("blasx.ring.block"):
            y[slot * m_local:(slot + 1) * m_local] = _dot(chunk, w_acc)
        if reqs is not None:
            with span("blasx.ring.wait"):
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
    x_acc, w_acc = _ring_operands(x_local, w_local, group)
    (_, y), = _ring_pieces(x_acc, w_acc, group, 1,
                           torch.promote_types(x_local.dtype, w_local.dtype))
    return y


def _ring_operands(x_local: torch.Tensor, w_local: torch.Tensor,
                   group) -> tuple:
    """The ring's operands: X's rows padded with zeros up to a multiple
    of the ring, and both widened to the accumulation dtype, once, not
    once a block."""
    d = dist.get_world_size(group)
    mb = -(-x_local.shape[0] // d)
    acc_dtype = _acc_type(x_local.dtype, w_local.dtype)
    with span("blasx.gemm.prep"):
        x_pad = _prepped(_pad_rows(x_local, mb * d), x_local)
        x_acc = _prepped(x_pad.to(acc_dtype), x_pad)
        w_acc = _prepped(w_local.to(acc_dtype), w_local)
    return x_acc, w_acc


def _ring_pieces(x_acc: torch.Tensor, w_acc: torch.Tensor, group,
                 slabs: int, out_dtype: torch.dtype):
    """The ring reduce-scatter of ``x_acc @ w_acc`` over ``group``, its
    rows split into ``slabs`` contiguous slabs of S rows run as one
    pipeline.  Yields ``(j, piece)`` for each slab j in turn: this
    rank's rows ``j*S + idx*S/d`` .. of the sum, in ``out_dtype``,
    launched but not finished.

    Within a slab the accumulator's hop runs under the next block's
    product; a slab's last hop is waited on only after the next slab's
    first product has been launched, so no stream waits on a hop while
    a product that could hide it is still to be launched.
    """
    d, idx = dist.get_world_size(group), dist.get_rank(group)
    rows = x_acc.shape[0] // slabs
    mb = rows // d

    def block(j, b):
        with span("blasx.ring.block"):
            lo = j * rows + b * mb
            return torch.matmul(x_acc[lo:lo + mb], w_acc)

    def arrived(moved, reqs, part):
        with span("blasx.ring.wait"):
            for r in reqs:
                r.wait()
        with span("blasx.ring.accumulate"):
            return moved + part

    def finished(j, moved, reqs, part):
        acc = part if moved is None else arrived(moved, reqs, part)
        with span("blasx.ring.accumulate"):
            return j, acc.to(out_dtype)

    last = None     # the slab whose last hop is in flight
    for j in range(slabs):
        # start with the block that travels the whole ring (locality-
        # first: it is computed from the panel already on this rank)
        acc = block(j, (idx - 1) % d)
        if last is not None:
            yield finished(*last)
            last = None     # its buffers go before this slab's next
        moved = reqs = None
        part = acc
        for s in range(1, d):
            if moved is not None:
                acc = arrived(moved, reqs, part)
            moved, reqs = _hop(acc, group)
            part = block(j, (idx - 1 - s) % d)   # overlap: matmul vs hop
        last = (j, moved, reqs, part)
    yield finished(*last)


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
    above, re-gathered over ``col_axis``.  Where the row group's m_r
    rows split into P > 1 slabs (:func:`_slabs`: P of 4, 2 whose
    products keep at least 2048 rows), the ring runs them as one
    pipeline, and each slab's piece is all-gathered over ``col_axis``
    straight into its rows of one output while the next slab's products
    run; the gathers are waited on at the end.  On a one-rank row axis
    that output is C, so nothing is copied after the ring.  Ragged
    shapes (M not divisible by the row axis, K not by the column axis,
    or a row shard not by the ring) are padded with zeros and the
    result sliced back to ``(M, N)``.
    """
    global RING_SLABS
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}")
    shape = mesh_shape(mesh)
    dr, dc = shape[row_axis], shape[col_axis]
    r, c = mesh.get_local_rank(row_axis), mesh.get_local_rank(col_axis)
    rows, cols = axis_group(mesh, row_axis), axis_group(mesh, col_axis)
    m, k = A.shape
    mr, kc = -(-m // dr), -(-k // dc)
    with span("blasx.gemm.prep"):
        A = _prepped(torch.nn.functional.pad(
            A, (0, kc * dc - k, 0, mr * dr - m)), A)
        B = _prepped(_pad_rows(B, kc * dc), B)
        a_blk = A[r * mr:(r + 1) * mr, c * kc:(c + 1) * kc]
        b_blk = B[c * kc:(c + 1) * kc]
    if mode == "ring":
        slabs = _slabs(mr, dc)
        RING_SLABS += slabs
        if slabs > 1:
            y = _slab_ring(a_blk, b_blk, cols, slabs)
            if dr == 1:
                return y
            with span("blasx.gemm.gather"):
                return all_gather(y, rows)[:m]
        y = ring_reduce_scatter_matmul(a_blk, b_blk, cols)
    else:
        y = all_reduce(_dot(a_blk, b_blk), cols).to(
            torch.promote_types(a_blk.dtype, b_blk.dtype))
    with span("blasx.gemm.gather"):
        if mode == "ring":
            # the ring pads ragged row shards up to the next ring multiple
            y = all_gather(y, cols)[:mr]
        return all_gather(y, rows)[:m]


def _slabs(rows: int, d: int) -> int:
    """Slabs for the ring of a row group of ``rows`` rows over ``d``
    ranks: the most of :data:`_SLABS` that divide it evenly into
    ``slabs * d`` products of at least :data:`_SLAB_ROWS` rows each."""
    return next(p for p in _SLABS
                if p == 1 or (rows % (p * d) == 0
                              and rows // (p * d) >= _SLAB_ROWS))


def _slab_ring(x_local: torch.Tensor, w_local: torch.Tensor, group,
               slabs: int) -> torch.Tensor:
    """The sum over ``group`` of ``x_local @ w_local``, whole on every
    rank: the ring's pieces of each of ``slabs`` row slabs all-gathered
    over ``group`` into one output as they come, and waited on after the
    last."""
    x_acc, w_acc = _ring_operands(x_local, w_local, group)
    out = x_acc.new_empty((x_acc.shape[0], w_acc.shape[1]),
                          dtype=torch.promote_types(x_local.dtype,
                                                    w_local.dtype))
    rows = out.shape[0] // slabs
    posted = []
    for j, piece in _ring_pieces(x_acc, w_acc, group, slabs, out.dtype):
        with span("blasx.gemm.gather"):
            # the piece is held until its gather has been waited on
            posted.append((piece, _gather_into(
                out[j * rows:(j + 1) * rows], piece, group)))
    with span("blasx.gemm.gather_wait"):
        for _, work in posted:
            work.wait()
    return out


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
    zeros up to the next multiple and the result sliced back; W's
    columns (column) or rows (row) must divide evenly over the ring, or
    it raises ``ValueError``, as the reference's ``shard_map`` does.
    Rows are gathered and scattered sequence by sequence, so a local
    batch of several sequences keeps each sequence's rows together.
    """
    ag, rs = MODES[mode]
    if kind not in ("column", "row"):
        raise ValueError(f"kind must be column|row, got {kind}")
    shape = mesh_shape(mesh)
    d, j = shape[axis], mesh.get_local_rank(axis)
    group = axis_group(mesh, axis)
    bsz, s = x.shape[0], x.shape[1]
    db = shape[batch_axis] if batch_axis else 1
    if bsz % db:
        raise ValueError(f"batch {bsz} not divisible by the {batch_axis!r} "
                         f"axis of size {db}")
    bl = bsz // db
    bi = mesh.get_local_rank(batch_axis) if batch_axis else 0
    split = w.shape[1] if kind == "column" else w.shape[0]
    if split % d:
        # the reference's shard_map refuses a W it cannot split evenly
        raise ValueError(f"tp_matmul kind={kind!r}: W's "
                         f"{'columns' if kind == 'column' else 'rows'} "
                         f"({split}) are not evenly divisible by the "
                         f"{axis!r} axis of size {d}")
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
        y = all_gather(y, axis_group(mesh, batch_axis))
    return y[:, :s]
