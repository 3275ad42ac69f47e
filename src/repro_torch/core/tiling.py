"""Tile representation of matrices (paper §III-A).

A matrix of shape (M, N) with tile size T is logically partitioned into
ceil(M/T) x ceil(N/T) tiles; interior tiles are T x T, edge tiles are
ragged.  Tiles are identified by ``TileKey(matrix_id, i, j)`` — the
"host address" of the paper's runtime.  The runtime never copies the
full matrix; tasks carry tile keys and the engine materializes tile
views on demand.

In the port a matrix's data is a host (CPU) ``torch.Tensor``.  A numpy
input is wrapped with ``torch.from_numpy``, which shares its memory,
so tiling a matrix never copies it; tiles move to the device one at a
time in the runtime, and ``write_tile`` is the device-to-host
write-back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Tuple

import numpy as np
import torch

from .dtypes import canonical_dtype


@dataclasses.dataclass(frozen=True, order=True)
class TileKey:
    """Unique identity of one tile: which matrix, which (row, col) block."""

    matrix_id: str
    i: int
    j: int

    def __repr__(self) -> str:  # compact, used in ledgers/logs
        return f"{self.matrix_id}[{self.i},{self.j}]"


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Tile decomposition of one matrix (paper §III-A)."""

    matrix_id: str
    rows: int
    cols: int
    tile: int

    @property
    def n_tile_rows(self) -> int:
        return max(1, math.ceil(self.rows / self.tile))

    @property
    def n_tile_cols(self) -> int:
        return max(1, math.ceil(self.cols / self.tile))

    @property
    def n_tiles(self) -> int:
        return self.n_tile_rows * self.n_tile_cols

    def tile_shape(self, i: int, j: int) -> Tuple[int, int]:
        """Shape of tile (i, j); edge tiles are ragged."""
        self._check(i, j)
        h = min(self.tile, self.rows - i * self.tile)
        w = min(self.tile, self.cols - j * self.tile)
        return (h, w)

    def tile_slice(self, i: int, j: int) -> Tuple[slice, slice]:
        self._check(i, j)
        r0 = i * self.tile
        c0 = j * self.tile
        h, w = self.tile_shape(i, j)
        return (slice(r0, r0 + h), slice(c0, c0 + w))

    def key(self, i: int, j: int) -> TileKey:
        self._check(i, j)
        return TileKey(self.matrix_id, i, j)

    def nbytes(self, i: int, j: int, itemsize: int = 8) -> int:
        h, w = self.tile_shape(i, j)
        return h * w * itemsize

    def keys(self) -> Iterator[TileKey]:
        for i in range(self.n_tile_rows):
            for j in range(self.n_tile_cols):
                yield self.key(i, j)

    def _check(self, i: int, j: int) -> None:
        if not (0 <= i < self.n_tile_rows and 0 <= j < self.n_tile_cols):
            raise IndexError(
                f"tile ({i},{j}) out of grid "
                f"{self.n_tile_rows}x{self.n_tile_cols} of {self.matrix_id}"
            )


def host_tensor(data) -> torch.Tensor:
    """A CPU tensor view of ``data``: numpy arrays are shared, not
    copied; tensors must already live on the host."""
    if isinstance(data, torch.Tensor):
        if data.device.type != "cpu":
            raise ValueError(
                f"matrices live in host memory; got a tensor on "
                f"{data.device} (pass .cpu() explicitly)")
        return data
    return torch.from_numpy(np.asarray(data))


class TiledMatrix:
    """A matrix plus its tile grid.  Host-resident (paper: matrices stay in
    host RAM; GPUs operate out-of-core on tiles)."""

    def __init__(self, matrix_id: str, data, tile: int):
        self.data = host_tensor(data)
        if self.data.ndim != 2:
            raise ValueError(f"{matrix_id}: expected 2-D, got {self.data.shape}")
        self.grid = TileGrid(matrix_id, self.data.shape[0], self.data.shape[1], tile)

    @property
    def matrix_id(self) -> str:
        return self.grid.matrix_id

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def read_tile(self, i: int, j: int) -> torch.Tensor:
        """A host view of tile (i, j) (no copy)."""
        rs, cs = self.grid.tile_slice(i, j)
        return self.data[rs, cs]

    def write_tile(self, i: int, j: int, value: torch.Tensor) -> None:
        """Copy ``value`` (on any device) into tile (i, j) of the host
        matrix: the write-back of a finished output tile."""
        rs, cs = self.grid.tile_slice(i, j)
        expected = self.grid.tile_shape(i, j)
        if tuple(value.shape) != expected:
            raise ValueError(
                f"write_tile({i},{j}): shape {value.shape} != {expected}"
            )
        self.data[rs, cs].copy_(value)

    def nbytes(self, i: int, j: int) -> int:
        return self.grid.nbytes(i, j, self.data.element_size())


class ShadowMatrix:
    """Shape-only stand-in for metadata-only runs (execute=False):
    carries the tile grid and byte sizes, never any data.  Lets the
    scheduling/cache/ledger machinery run at the paper's true scale
    (N up to 40K, any precision) without allocating gigabytes.
    ``dtype`` (preferred) or ``itemsize`` sets the byte accounting."""

    def __init__(self, matrix_id: str, rows: int, cols: int, tile: int,
                 itemsize: int = 8, dtype=None):
        self.grid = TileGrid(matrix_id, rows, cols, tile)
        self.dtype = canonical_dtype(dtype) if dtype is not None else None
        self.itemsize = (self.dtype.itemsize if self.dtype is not None
                         else itemsize)

    @property
    def matrix_id(self) -> str:
        return self.grid.matrix_id

    def nbytes(self, i: int, j: int) -> int:
        return self.grid.nbytes(i, j, self.itemsize)

    def read_tile(self, i: int, j: int):  # pragma: no cover
        raise RuntimeError("ShadowMatrix holds no data (execute=False runs)")

    def write_tile(self, i: int, j: int, value) -> None:  # pragma: no cover
        raise RuntimeError("ShadowMatrix holds no data (execute=False runs)")


def workcentric_parts(n_steps: int, n_owner: int, capacity: int,
                      ragged: bool) -> int:
    """How many partial-k tasks the work-centric split planner carves
    from one task's k-loop (Stream-K, arXiv 2301.03598); 0 leaves the
    task in owner form.

    Two triggers (see ``repro_torch.core.task.plan_work_centric``):

    * *small problem* — the whole owner-task count is below the
      machine's device x stream ``capacity``, so every splittable task
      is cut into enough pieces to roughly fill two full waves;
    * *boundary tile* — on large problems only ragged output tiles
      split (in half), shortening the tail without perturbing the
      interior schedule.

    Deterministic and purely arithmetic so
    :func:`degree_of_parallelism` and the tuning-layer step estimates
    can mirror the planner exactly.
    """
    if n_steps < 2 or capacity <= 0 or n_owner <= 0:
        return 0
    if n_owner < capacity:
        return min(n_steps, max(2, -(-2 * capacity // n_owner)))
    if ragged:
        return min(n_steps, 2)
    return 0


def panel_parts(task_bytes: int, cache_bytes: int, n_steps: int) -> int:
    """How many panel-sized partials the pod-tier staging planner carves
    from one beyond-HBM task's k-loop (see
    ``repro_torch.core.task.plan_panel_staged``); 0 leaves the task whole.

    A task whose k-loop input working set (``task_bytes``) fits the
    device's HBM (``cache_bytes``) keeps its tiles resident through the
    normal ALRU path and needs no staging.  Truly beyond-HBM tasks are
    cut into contiguous panels of at most half the HBM each (headroom
    for a concurrent stream) — ``ceil(task_bytes / (cache_bytes/2))``
    — capped at one panel per k-step.  Deterministic and purely
    arithmetic, like :func:`workcentric_parts`.
    """
    if cache_bytes <= 0 or n_steps < 2 or task_bytes <= cache_bytes:
        return 0
    budget = max(1, cache_bytes // 2)
    return min(n_steps, -(-task_bytes // budget))


def split_ranges(n_steps: int, n_parts: int) -> list:
    """Partition ``range(n_steps)`` into ``n_parts`` contiguous
    ``(start, stop)`` k-ranges whose sizes differ by at most one."""
    if n_parts <= 0:
        raise ValueError("n_parts must be positive")
    n_parts = min(n_parts, n_steps)
    base, extra = divmod(n_steps, n_parts)
    out = []
    start = 0
    for p in range(n_parts):
        stop = start + base + (1 if p < extra else 0)
        out.append((start, stop))
        start = stop
    return out


def degree_of_parallelism(m: int, n: int, tile: int, k: int = None,
                          work_centric: bool = False,
                          capacity: int = 8) -> int:
    """Paper Eq. 2: ceil(M/T) * ceil(N/T) independent output tiles.

    Under the work-centric mode the owner-only count undercounts what
    the scheduler actually sees: every split tile contributes its
    partial-k tasks *plus* the fix-up reduction.  ``k`` (defaults to
    ``m``) sets the k-loop depth and ``capacity`` the device x stream
    budget the split planner fills against (the default matches the
    stock 2-device, 4-stream
    :class:`~repro_torch.core.runtime.RuntimeConfig`).
    """
    rows = math.ceil(m / tile)
    cols = math.ceil(n / tile)
    owner = rows * cols
    if not work_centric:
        return owner
    kk = m if k is None else k
    n_steps = max(1, math.ceil(kk / tile))
    parts = workcentric_parts(n_steps, owner, capacity, ragged=True)
    if parts == 0:
        return owner
    if owner < capacity:
        split = owner
    else:
        split = owner - (m // tile) * (n // tile)
    return owner + split * parts
