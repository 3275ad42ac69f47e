"""Public matmul wrapper around the hand-written kernel.

The counterpart of the reference's ``kernels/ops.py::matmul``: any
``(M, K) x (K, N)``, an optional bias row and activation applied to the
sums (the fused epilogue), ``out_dtype`` defaulting to the promoted
input type, the same ``ValueError``s.  It runs as the G=1, S=1 case of the
batched kernel in ``kernels.matmul``.  There is no padding step: the
kernel masks ragged edges itself.  Block shapes come from the compiled
table of the path the call takes (``kernels.matmul.kernel_path``), each
bounded by the card's shared memory per block (see
``kernels.matmul.default_blocks``), not by a TPU's VMEM.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.dtypes import canonical_dtype, promote_dtypes
from .matmul import (SMEM_BUDGET, batched_contract, check_epilogue,
                     default_blocks, kernel_path, operand_path, smem_bytes)

__all__ = ["matmul", "default_blocks", "kernel_path", "smem_bytes",
           "SMEM_BUDGET"]


def matmul(a: torch.Tensor, b: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *,
           activation: Optional[str] = None, out_dtype=None,
           block_m: Optional[int] = None, block_n: Optional[int] = None,
           block_k: Optional[int] = None) -> torch.Tensor:
    """``C = activation(A @ B + bias)`` through the hand-written kernel
    (CUDA tensors) or its plain version (CPU tensors).  ``bias`` holds N
    values and is added in the accumulator type; ``activation`` is one of
    none/relu/gelu (tanh form)/silu/tanh.

    ``block_m``/``block_n``/``block_k`` override the blocks of the path
    the call takes (``kernel_path`` of the converted operands): wgmma
    takes (128, 128 or 256, 64), dmma (64 or 128, 64, 16), simt {64,
    128}^2 x {16} (``compiled_blocks``).  A block
    outside that path's table raises ``ValueError``; the sizes not given
    come from that path's default."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"matmul expects 2-D operands, got "
                         f"{tuple(a.shape)} {tuple(b.shape)}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    check_epilogue(bias, activation, n)
    dt = promote_dtypes(a.dtype, b.dtype)
    out_dtype = canonical_dtype(out_dtype) if out_dtype is not None else dt
    a = a.to(dt).contiguous()
    b = b.to(dt).contiguous()
    blocks = None
    if block_m or block_n or block_k:
        dbm, dbn, dbk = default_blocks(m, n, k, dt.itemsize,
                                       operand_path(a, b))
        blocks = (block_m or dbm, block_n or dbn, block_k or dbk)
    return batched_contract(a[None, None], b[None, None], out_dtype,
                            blocks=blocks, bias=bias,
                            activation=activation)[0]
