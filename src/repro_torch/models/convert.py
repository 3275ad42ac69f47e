"""Carry a reference parameter tree over to the port.

The reference builds its parameters with ``jax.random``; the port draws
its own from a ``torch.Generator``, so the two never hold the same
numbers from one seed.  To hold the port's model against the
reference's, a test builds the reference's tree, widens it to float32
numpy arrays (the port cannot import ``ml_dtypes``, numpy's bfloat16)
and hands it to :func:`params_from_reference`; the optimizer state
beside it goes over with :func:`opt_state_from_reference`.  Under a
mesh both take the port's ``placements`` (``Model(cfg, rules)
.placements()``: the rules alone do not say which logical axes a leaf
has) and keep each rank's block of every global array, as the
reference's ``device_put`` does, so both packages start from one tree.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .sharding import place


def params_from_reference(tree: Mapping[str, Any], dtype: torch.dtype,
                          device="cuda", placements: Any = None) -> dict:
    """Nested dicts of float32 numpy arrays -> the same nested dicts of
    tensors of ``dtype`` on ``device`` (the card unless the caller asks
    for the CPU): same keys, same (stacked) shapes, or, with
    ``placements`` (the tree's, under a mesh), this rank's block of each
    array."""
    out = {}
    for key, leaf in tree.items():
        pl = None if placements is None else placements[key]
        if isinstance(leaf, Mapping):
            out[key] = params_from_reference(leaf, dtype, device, pl)
            continue
        arr = np.asarray(leaf)
        if arr.dtype != np.float32:
            raise TypeError(f"{key}: expected a float32 array, got "
                            f"{arr.dtype} (widen bf16 leaves to f32 first)")
        # a copy: the tree may be a read-only view of the reference's
        # buffers
        out[key] = place(torch.tensor(arr, dtype=dtype, device=device), pl)
    return out


def opt_state_from_reference(state: Mapping[str, Any], device="cuda",
                             placements: Any = None) -> dict:
    """The reference's ``adamw.init_state`` tree as numpy (``m`` and
    ``v``: nested dicts of float32 arrays beside the parameters;
    ``step``: an int32 scalar) -> the port's AdamW state on ``device``
    (the card unless the caller asks for the CPU): f32 moments (each
    rank's blocks at the parameters' ``placements`` under a mesh), an
    int32 step."""
    step = np.asarray(state["step"])
    if step.shape != () or step.dtype != np.int32:
        raise TypeError(f"step: expected an int32 scalar, got "
                        f"{step.dtype} of shape {step.shape}")
    return {"m": params_from_reference(state["m"], torch.float32, device,
                                       placements),
            "v": params_from_reference(state["v"], torch.float32, device,
                                       placements),
            "step": torch.tensor(step, device=device)}
