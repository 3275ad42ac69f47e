"""The plain reference of a GEMM, and the comparison that decides
``correct``.

Plain PyTorch only: nothing of the port, of its kernels' plain versions
or of its tests.  The reference recomputes ``A @ B`` from the inputs the
harness handed the program, in float64, one block of rows at a time, and
reads the program's outputs only to judge them.  Two numbers a output:

  ``normwise``  ||C - R||_F / ||R||_F
  ``maxrel``    max |C - R| / max |R|   (one altered element shows here)

The control (``lower_precision``) is this reference computed in the
next precision below the configuration's: float32 with TF32 off for a
float64 configuration, TF32 for a float32 one.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

ROW_BLOCK = 2048
NUMBERS = ("normwise", "maxrel")


def compare(A: torch.Tensor, B: torch.Tensor, outputs: Sequence[torch.Tensor],
            device, row_block: int = ROW_BLOCK) -> List[Dict[str, float]]:
    """``normwise`` and ``maxrel`` of every output against A @ B in
    float64, computed on ``device`` a block of ``row_block`` rows at a
    time (A, B and the outputs may live on the host or the device)."""
    b = B.to(device=device, dtype=torch.float64)
    m = A.shape[0]
    acc = [[0.0, 0.0, 0.0] for _ in outputs]  # sum d^2, max |d|, ...
    ref_sq = 0.0
    ref_max = 0.0
    for r0 in range(0, m, row_block):
        r1 = min(m, r0 + row_block)
        ref = A[r0:r1].to(device=device, dtype=torch.float64) @ b
        ref_sq += float(torch.sum(ref * ref))
        ref_max = max(ref_max, float(ref.abs().max()))
        for i, out in enumerate(outputs):
            got = out[r0:r1].to(device=device, dtype=torch.float64)
            d = got - ref
            acc[i][0] += float(torch.sum(d * d))
            # a NaN anywhere must read as NaN, not vanish in a max
            acc[i][1] = max(acc[i][1], float(d.abs().max()))
            acc[i][2] += float(torch.isnan(d).sum())
        del ref
    out = []
    for sq, mx, nans in acc:
        if nans:
            out.append({"normwise": math.nan, "maxrel": math.nan})
            continue
        out.append({"normwise": math.sqrt(sq / ref_sq) if ref_sq else
                    (0.0 if sq == 0 else math.inf),
                    "maxrel": mx / ref_max if ref_max else
                    (0.0 if mx == 0 else math.inf)})
    return out


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (half away from
    zero), as the tensor cores read them."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.bitwise_and(i + 0x1000, -0x2000).view(torch.float32)


def lower_precision(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype,
                    control: str) -> torch.Tensor:
    """A @ B computed as the control computes it, returned in ``dtype``:
    ``"float32"`` (TF32 off), or ``"tf32"`` (on the card cuBLAS with
    TF32 on; on the host float32 on operands rounded to TF32)."""
    if control not in ("float32", "tf32"):
        raise ValueError(f"unknown control {control!r}")
    a, b = a.to(torch.float32), b.to(torch.float32)
    if control == "tf32" and a.device.type != "cuda":
        a, b = round_tf32(a), round_tf32(b)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = control == "tf32"
    try:
        return torch.matmul(a, b).to(dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
