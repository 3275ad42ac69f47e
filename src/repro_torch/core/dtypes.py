"""Precision registry for multi-precision L3 BLAS (PyTorch port).

The registry is keyed by the numpy-style names the reference uses
(``"float64"``, ``"float32"``, ``"float16"``, ``"bfloat16"``) and maps
each to its ``torch.dtype``.  Every name runs on both backends of the
port:

  * ``torch`` — one batched library matmul per step group (the
    fallback, like the reference's jax backend);
  * ``cuda``  — full-fill groups through the hand-written kernel in
    ``repro_torch.kernels``.

Both accumulate float64 in float64 and every narrower storage type in
float32, then cast back to the storage type.  Byte accounting is
storage-dtype accounting (``h * w * itemsize``), exactly as in the
reference, so the ALRU/heap capacity model and the transfer ledger
match it byte for byte.

The group signatures the runtime forms (``StepGroupKey.dtype``) carry
the *name* string, not the ``torch.dtype``, so group formation — and
with it the ledger — is identical to the reference's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_ALL_BACKENDS: Tuple[str, ...] = ("torch", "cuda")
# storage dtype name -> backends allowed to execute it
SUPPORTED_DTYPES: Dict[str, Tuple[str, ...]] = {
    "float64": _ALL_BACKENDS,
    "float32": _ALL_BACKENDS,
    "float16": _ALL_BACKENDS,
    "bfloat16": _ALL_BACKENDS,
}

TORCH_DTYPES: Dict[str, torch.dtype] = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}
_NAMES: Dict[torch.dtype, str] = {v: k for k, v in TORCH_DTYPES.items()}


def dtype_name(dtype) -> str:
    """The registry name of a supported dtype (any spelling)."""
    return _NAMES[canonical_dtype(dtype)]


def canonical_dtype(dtype) -> torch.dtype:
    """Normalize any dtype spelling (name string, ``torch.dtype``,
    ``np.dtype`` or numpy scalar type) to the ``torch.dtype``; rejects
    dtypes outside the supported set."""
    if isinstance(dtype, torch.dtype):
        if dtype in _NAMES:
            return dtype
        raise ValueError(f"unsupported dtype {dtype}; L3 routines support "
                         f"{sorted(SUPPORTED_DTYPES)}")
    name = str(dtype).replace("torch.", "")
    if name not in SUPPORTED_DTYPES:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            raise ValueError(f"unsupported dtype {dtype!r}") from None
    if name not in SUPPORTED_DTYPES:
        raise ValueError(
            f"unsupported dtype {name!r}; L3 routines support "
            f"{sorted(SUPPORTED_DTYPES)}")
    return TORCH_DTYPES[name]


def validate_backend_dtype(dtype, backend: str) -> torch.dtype:
    """Check that ``backend`` can execute ``dtype``; returns the
    canonical dtype."""
    dt = canonical_dtype(dtype)
    name = _NAMES[dt]
    allowed = SUPPORTED_DTYPES[name]
    if backend not in allowed:
        raise ValueError(
            f"dtype {name!r} is not supported on the {backend!r} backend "
            f"({name} needs one of {list(allowed)})")
    return dt


def promote_dtypes(a, b) -> torch.dtype:
    """``torch.promote_types`` over two supported dtypes.  bfloat16 x
    float16 has no common precision in the reference (numpy refuses
    it), while torch would silently widen to float32; the port keeps
    the reference's error so both packages accept the same calls."""
    da, db = canonical_dtype(a), canonical_dtype(b)
    if da == db:
        return da
    if {da, db} == {torch.bfloat16, torch.float16}:
        raise ValueError(
            f"no common precision between {_NAMES[da]} and {_NAMES[db]} "
            f"operands; pass an explicit dtype=")
    return torch.promote_types(da, db)


def accumulator_dtype(dtype) -> torch.dtype:
    """float64 accumulates in float64, everything narrower in float32."""
    dt = canonical_dtype(dtype)
    return torch.float64 if dt == torch.float64 else torch.float32
