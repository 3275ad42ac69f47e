"""Execution-backend protocol: *how* tile math runs, decoupled from
*where/when* the scheduler runs it.

The BLASX runtime (``repro_torch.core.runtime``) treats tiles as the basic
task unit: the scheduler picks a device and an order; every tile
k-step then has to be multiplied somewhere.  The seed implementation
executed each step as one interpreted host call — faithful scheduling,
but every step paid full per-call dispatch overhead.  An
:class:`ExecutionBackend` instead receives a *group* of same-shape
steps (grouped by the runtime per device batch) and may execute the
whole group as one batched dispatch — the software analogue of packing
concurrent tile kernels onto a stream.

Contract
--------
* Tiles arriving at a backend are already **materialized**: the fill
  mask (triangular/symmetric storage semantics) and the paper-§III-C
  transpose trick were applied on the host, so ``a_tiles[i]`` is
  ``(m, k)`` and ``b_tiles[i]`` is ``(k, n)`` exactly as multiplied.
  The originating ``op/trans/fill`` metadata still rides on the
  :class:`StepGroupKey` so backends can specialize (the CUDA backend
  only routes full-fill groups to the hand-written kernel).
* ``run_group`` must return one accumulator per *item* (a
  ``key.steps``-deep multiply-accumulate chain; see
  :class:`StepGroupKey`), in order, as tensors on the device the
  tiles came from.  This is the one contract change from the
  reference, whose backends return numpy arrays: on a GPU that would
  cost one device-to-host copy per group, and the runtime's tile store
  and epilogue live on the device anyway.
* Backends must be callable from several device worker threads at once
  (``mode="threads"``); compile caches are the only allowed state.
* ``launches`` in the returned :class:`GroupResult` is the number of
  kernel dispatches the group cost — the ledger currency behind the
  ``launches saved`` statistic.
* :meth:`ExecutionBackend.solve_triangular` is the TRSM finalize solve
  of one tile.  The device backends solve on the tiles' device; the
  host backend solves as the reference does, with scipy.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import List, Sequence

import torch

from ..core import tile_kernels


@dataclasses.dataclass(frozen=True)
class StepGroupKey:
    """Batch signature: items sharing a key are dispatched together.

    One *item* is a ``steps``-deep multiply-accumulate chain
    ``acc = sum_j a_j @ b_j`` — a task's whole k-loop when the task is
    signature-uniform (the Stream-K-style work-centric unit), or a
    single step (``steps == 1``) when the runtime had to split a
    mixed-signature task.  ``m/k/n`` describe the *effective*
    (post-materialization) shape of one step's operands; ``dtype`` is
    the promoted accumulate dtype the caller expects back, as its
    registry name (``"float32"``), so signatures — and the ledger —
    are identical to the reference's."""

    op: str        # originating routine ("gemm", "syrk", ...)
    transa: bool
    transb: bool
    fill_a: str    # task.FILL_* constants of the stored tiles
    fill_b: str
    m: int
    k: int
    n: int
    dtype: str
    steps: int = 1  # k-steps contracted per item

    @property
    def flops_per_item(self) -> int:
        return 2 * self.m * self.k * self.n * self.steps

    @property
    def full_fill(self) -> bool:
        """Plain GEMM-shaped multiply chain (the hand-kernel path)."""
        return self.fill_a == "full" and self.fill_b == "full"


@dataclasses.dataclass
class GroupResult:
    """What one grouped dispatch produced."""

    products: List[torch.Tensor]  # one accumulator per item, in order
    launches: int                 # kernel dispatches this group cost
    engine: str                   # engine that actually ran ("torch"|"cuda")


class ExecutionBackend(abc.ABC):
    """One batched tile-op dispatcher (see module docstring)."""

    name: str = "?"

    @abc.abstractmethod
    def run_group(self, key: StepGroupKey, a_tiles: Sequence[torch.Tensor],
                  b_tiles: Sequence[torch.Tensor]) -> GroupResult:
        """Execute ``len(a_tiles) // key.steps`` items — each the
        ``key.steps``-deep chain ``sum_j a[i*steps+j] @ b[i*steps+j]``
        over same-shape tiles (item-major order) — as one logical
        dispatch wherever the engine allows; returns one accumulator
        per item."""

    def solve_triangular(self, a: torch.Tensor, b: torch.Tensor,
                         lower: bool, unit_diag: bool) -> torch.Tensor:
        """Tile-level solve ``a @ x = b`` for the TRSM finalize step."""
        return tile_kernels.solve_triangular(a, b, lower=lower,
                                             unit_diag=unit_diag)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"{type(self).__name__}()"
