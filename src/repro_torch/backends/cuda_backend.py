"""CUDA backend: full-fill tile groups on the hand-written kernel.

Routing is the reference's Pallas backend's, unchanged: every full-fill
``gemm``/``syrk``/``syr2k``/``symm`` group — of every storage type,
float64 included — goes to ``repro_torch.kernels.matmul.batched_contract``
as one launch that walks each item's k-chain in place.  Everything else
(triangular/symmetric fills, TRMM/TRSM steps, mixed-signature tasks
split into single steps) goes to the batched :class:`TorchBackend`.

Unlike the reference, float64 runs in true float64 through the kernel;
the reference's "f64" through Pallas is f32 arithmetic.  Integer groups
run on the kernel's f64 path and are rounded back (``core.dtypes``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.dtypes import storage_dtype
from ..kernels import matmul as kernel_matmul
from .base import ExecutionBackend, GroupResult, StepGroupKey
from .torch_backend import TorchBackend, compute_dtype, stack_items

# ops whose full-fill steps are plain C += A @ B tile multiplies
_KERNEL_OPS = ("gemm", "syrk", "syr2k", "symm")


class CudaBackend(ExecutionBackend):
    name = "cuda"

    def __init__(self):
        self._fallback = TorchBackend()

    def _route_to_kernel(self, key: StepGroupKey) -> bool:
        return key.full_fill and key.op in _KERNEL_OPS

    def run_group(self, key: StepGroupKey, a_tiles: Sequence[torch.Tensor],
                  b_tiles: Sequence[torch.Tensor]) -> GroupResult:
        if not self._route_to_kernel(key):
            return self._fallback.run_group(key, a_tiles, b_tiles)
        a, b = stack_items(key, a_tiles, b_tiles)
        out = kernel_matmul.batched_contract(a, b, compute_dtype(key))
        out = out.to(storage_dtype(key.dtype))
        return GroupResult(list(out.unbind(0)), launches=1, engine=self.name)
