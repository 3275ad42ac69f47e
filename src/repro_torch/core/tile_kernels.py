"""Tile materialization + the per-tile TRSM solver for the runtime.

Fill modifiers realize triangular/symmetric *storage* semantics: stored
tiles are always dense, only the ``uplo`` triangle is meaningful, so we
mask/symmetrize on load (before the §III-C transpose trick).  Both run
with ``torch.triu``/``tril``/``eye`` on the device the tile lives on.

The TRSM finalize solve was never a Pallas kernel: the reference runs
it on the host with scipy.  The port solves on the tile's device with
``torch.linalg.solve_triangular``, which reads only the named triangle,
as scipy does.  CUDA's solve takes no half types, so bfloat16/float16
tiles are solved in float32 and cast back.
"""
from __future__ import annotations

import torch

from .task import (FILL_FULL, FILL_SYM_L, FILL_SYM_U, FILL_TRI_L,
                   FILL_TRI_LU, FILL_TRI_U, FILL_TRI_UU, TileRef)


def _eye_like(tile: torch.Tensor) -> torch.Tensor:
    return torch.eye(tile.shape[0], tile.shape[1], dtype=tile.dtype,
                     device=tile.device)


def apply_fill(tile: torch.Tensor, fill: str) -> torch.Tensor:
    if fill == FILL_FULL:
        return tile
    if fill == FILL_SYM_U:
        return torch.triu(tile) + torch.triu(tile, 1).T
    if fill == FILL_SYM_L:
        return torch.tril(tile) + torch.tril(tile, -1).T
    if fill == FILL_TRI_U:
        return torch.triu(tile)
    if fill == FILL_TRI_L:
        return torch.tril(tile)
    if fill == FILL_TRI_UU:
        return torch.triu(tile, 1) + _eye_like(tile)
    if fill == FILL_TRI_LU:
        return torch.tril(tile, -1) + _eye_like(tile)
    raise ValueError(f"unknown fill {fill}")


def materialize(tile: torch.Tensor, ref: TileRef) -> torch.Tensor:
    out = apply_fill(tile, ref.fill)
    if ref.trans:
        out = out.T
    return out


def solve_triangular(a: torch.Tensor, b: torch.Tensor, lower: bool,
                     unit_diag: bool) -> torch.Tensor:
    """Tile-level triangular solve ``a @ x = b`` for the TRSM finalize
    step, on the tiles' device."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    work = out_dtype if out_dtype in (torch.float64, torch.float32) \
        else torch.float32
    x = torch.linalg.solve_triangular(
        a.to(work), b.to(work), upper=not lower, unitriangular=unit_diag)
    return x.to(out_dtype)
