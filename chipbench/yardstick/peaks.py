"""Frozen peaks of one card and the operation and byte counts of a GEMM.

Peaks: NVIDIA H100 Tensor Core GPU data sheet, H100 SXM5 80 GB, dense
rates (no sparsity) at the card's full 700 W power limit: FP64 tensor
core 67 TFLOP/s, FP32 67 TFLOP/s, TF32 tensor core 495 TFLOP/s, BF16 and
FP16 989 TFLOP/s, HBM3 3.35 TB/s.  A card set below that limit runs
slower under load; every run prints the limit it found.
"""
from __future__ import annotations

from typing import Tuple

# FLOP/s of one card by the dtype a GEMM computes in.  float64 runs on
# the FP64 tensor cores (the port's dmma path), float32 with TF32 off on
# the CUDA cores.
PEAK_FLOPS = {
    "float64": 67e12,
    "float32": 67e12,
    "tfloat32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
}
PEAK_BYTES_PER_S = 3.35e12


def gemm_flops(m: int, n: int, k: int) -> int:
    """Useful operations of C[m, n] = A[m, k] @ B[k, n]: one multiply
    and one add per term."""
    return 2 * m * n * k


def gemm_bytes(m: int, n: int, k: int, itemsize: int) -> int:
    """Least traffic of the same GEMM: each operand read once, C
    written once."""
    return (m * k + k * n + m * n) * itemsize


def least_time(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """The least time one card could take, and which bound sets it
    (``"compute"`` or ``"memory"``)."""
    t_compute = flops / PEAK_FLOPS[dtype]
    t_memory = nbytes / PEAK_BYTES_PER_S
    if t_compute >= t_memory:
        return t_compute, "compute"
    return t_memory, "memory"


def share_pct(bound_s: float, measured_s: float):
    """A roofline share in percent, or None where nothing was measured.
    Never clipped: a share over 100 says the count or the time is
    wrong."""
    if not measured_s or measured_s <= 0:
        return None
    return 100.0 * bound_s / measured_s
