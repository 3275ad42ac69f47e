"""Plain PyTorch versions of the hand-written kernels.

They compute the same functions as the CUDA kernels in ``csrc/`` with
the same accumulation types.  The CPU tests use them, the wrappers take
them for tensors that lie on the CPU, and ``chip_smoke.py`` holds each
kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.dtypes import accumulator_dtype


def batched_contract_ref(a: torch.Tensor, b: torch.Tensor,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """``c[g] = sum_s a[g, s] @ b[g, s]`` for a ``(G, S, M, K)`` and b
    ``(G, S, K, N)``, accumulated in float64 for float64 and float32
    otherwise, then cast to ``out_dtype`` (default: a's dtype)."""
    acc = accumulator_dtype(a.dtype)
    out = torch.einsum("gsmk,gskn->gmn", a.to(acc), b.to(acc))
    return out.to(out_dtype or a.dtype)


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` for 2-D operands of one dtype, accumulated as above."""
    acc = accumulator_dtype(a.dtype)
    return (a.to(acc) @ b.to(acc)).to(out_dtype or a.dtype)
