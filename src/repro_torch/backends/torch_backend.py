"""Batched library backend: a whole step group in one ``torch.matmul``.

The port's counterpart of the reference's jax backend, and the fallback
of the CUDA backend for every group the hand kernel does not take
(triangular/symmetric fills, TRMM/TRSM steps).  The group's tiles are
stacked into ``(G, steps, m, k)`` / ``(G, steps, k, n)`` and each item's
k-chain is folded into one ``(m, steps*k) @ (steps*k, n)`` contraction,
so the group costs one batched matmul: ``launches=1``.

Accumulation follows the reference's contract: float64 in float64 (on
the port that is true f64 — the reference narrows it to f32 unless jax
runs with x64), everything narrower in float32, then a cast back to
the group's storage type.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.dtypes import accumulator_dtype, canonical_dtype
from .base import ExecutionBackend, GroupResult, StepGroupKey


def stack_items(key: StepGroupKey, a_tiles: Sequence[torch.Tensor],
                b_tiles: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G*steps) tile lists -> contiguous ``(G, steps, m, k)`` /
    ``(G, steps, k, n)`` buffers in the group's dtype, on the tiles'
    device (one copy per operand)."""
    g = len(a_tiles) // key.steps
    dt = canonical_dtype(key.dtype)
    a = torch.stack([t.to(dt) for t in a_tiles])
    b = torch.stack([t.to(dt) for t in b_tiles])
    return (a.reshape(g, key.steps, key.m, key.k),
            b.reshape(g, key.steps, key.k, key.n))


class TorchBackend(ExecutionBackend):
    name = "torch"

    def __init__(self):
        # the reference holds f32 groups to 1e-4; TF32 keeps about three
        # decimal digits, so f32 products must run in full f32
        torch.backends.cuda.matmul.allow_tf32 = False

    def run_group(self, key: StepGroupKey, a_tiles: Sequence[torch.Tensor],
                  b_tiles: Sequence[torch.Tensor]) -> GroupResult:
        a, b = stack_items(key, a_tiles, b_tiles)
        g, s, m, k = a.shape
        acc = accumulator_dtype(a.dtype)
        a2 = a.to(acc).transpose(1, 2).reshape(g, m, s * k)
        b2 = b.to(acc).reshape(g, s * k, key.n)
        out = torch.matmul(a2, b2).to(a.dtype)
        return GroupResult(list(out.unbind(0)), launches=1, engine=self.name)
