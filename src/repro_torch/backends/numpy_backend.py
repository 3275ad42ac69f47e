"""Host-BLAS backend: the reference's numerically authoritative engine.

The port's counterpart of the reference's numpy backend.  Each k-step is
one ``np.dot`` call on the tiles' numpy views and each accumulate one
numpy add: no batching, one "launch" per step, per-step products summed
in the original k order.  Handed the same arrays, it gives the
reference's results bit for bit, which is what the parity suite holds
it to.

It is a host engine: tiles must live in host memory, so a runtime on
the card refuses it (``RuntimeConfig(backend="numpy")`` needs
``device="cpu"``), and a tile on the card raises here instead of being
copied off it.  Precisions: float64 and float32, computed in the
storage dtype; ``core.dtypes`` refuses float16/bfloat16 on it, as the
reference does.  Integer groups run ``np.dot`` in their own integer
type, as the reference's numpy engine does.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .base import ExecutionBackend, GroupResult, StepGroupKey

DEVICE_ERROR = ("the numpy backend is a host engine: its tiles live in "
                "host memory, so pass device=\"cpu\" with backend=\"numpy\"")


def _host_view(tile: torch.Tensor) -> np.ndarray:
    """The tile's memory as a numpy array (shared, same strides)."""
    if tile.device.type != "cpu":
        raise ValueError(f"{DEVICE_ERROR}; got a tile on {tile.device}")
    return tile.numpy()


class NumpyBackend(ExecutionBackend):
    name = "numpy"

    def run_group(self, key: StepGroupKey, a_tiles: Sequence[torch.Tensor],
                  b_tiles: Sequence[torch.Tensor]) -> GroupResult:
        s = key.steps
        a_np = [_host_view(t) for t in a_tiles]
        b_np = [_host_view(t) for t in b_tiles]
        products = []
        for i in range(0, len(a_np), s):
            acc = np.dot(a_np[i], b_np[i])
            for j in range(i + 1, i + s):
                acc = acc + np.dot(a_np[j], b_np[j])
            products.append(torch.from_numpy(acc))
        return GroupResult(products, launches=len(a_tiles),
                           engine=self.name)

    def solve_triangular(self, a: torch.Tensor, b: torch.Tensor,
                         lower: bool, unit_diag: bool) -> torch.Tensor:
        """The reference's host solve: scipy's ``solve_triangular`` on
        the tiles' numpy views."""
        import scipy.linalg  # only TRSM needs it, as in the reference

        return torch.from_numpy(scipy.linalg.solve_triangular(
            _host_view(a), _host_view(b), lower=lower,
            unit_diagonal=unit_diag, check_finite=False))
