"""Carry a reference parameter tree over to the port.

The reference builds its parameters with ``jax.random``; the port draws
its own from a ``torch.Generator``, so the two never hold the same
numbers from one seed.  To hold the port's model against the
reference's, a test builds the reference's tree, widens it to float32
numpy arrays (the port cannot import ``ml_dtypes``, numpy's bfloat16)
and hands it to :func:`params_from_reference`.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def params_from_reference(tree: Mapping[str, Any], dtype: torch.dtype,
                          device="cuda") -> dict:
    """Nested dicts of float32 numpy arrays -> the same nested dicts of
    tensors of ``dtype`` on ``device`` (the card unless the caller asks
    for the CPU): same keys, same (stacked) shapes."""
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[key] = params_from_reference(leaf, dtype, device)
            continue
        arr = np.asarray(leaf)
        if arr.dtype != np.float32:
            raise TypeError(f"{key}: expected a float32 array, got "
                            f"{arr.dtype} (widen bf16 leaves to f32 first)")
        # a copy: the tree may be a read-only view of the reference's
        # buffers
        out[key] = torch.tensor(arr, dtype=dtype, device=device)
    return out
