"""Precision registry for multi-precision L3 BLAS (PyTorch port).

The registry is keyed by the numpy-style names the reference uses
(``"float64"``, ``"float32"``, ``"float16"``, ``"bfloat16"``) and maps
each to its ``torch.dtype``.  Every name runs on the two device
backends of the port:

  * ``torch`` — one batched library matmul per step group (the
    fallback, like the reference's jax backend);
  * ``cuda``  — full-fill groups through the hand-written kernel in
    ``repro_torch.kernels``.

Both accumulate float64 in float64 and every narrower storage type in
float32, then cast back to the storage type.  The host backend
``numpy`` (the reference's numpy engine) takes float64 and float32
only, computed in the storage type; float16/bfloat16 raise on it, as
in the reference.  Byte accounting is
storage-dtype accounting (``h * w * itemsize``), exactly as in the
reference, so the ALRU/heap capacity model and the transfer ledger
match it byte for byte.

The group signatures the runtime forms (``StepGroupKey.dtype``) carry
the *name* string, not the ``torch.dtype``, so group formation — and
with it the ledger — is identical to the reference's.

Integer operands are outside the registry (a per-call ``dtype=`` of one
raises, as in the reference), but routines take them as the reference
does: mixed pairs promote exactly as ``np.promote_types`` (int64 x
float32 is float64), and int x int stays integer.  Integer groups are
computed in float64 and rounded back, so their sums are exact while
they stay below 2**53 in magnitude (the reference's numpy engine is
exact in int64; its jax engine stages int32 and sums in float32, exact
below 2**24).  On the ``numpy`` backend integer groups take the
reference's own route: ``np.dot`` in the group's integer type (then the
float64 alpha/beta epilogue both packages share), so they give the
reference's results bit for bit.  The registry gates only what a caller
may ask for, so integer operands run on every backend.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_ALL_BACKENDS: Tuple[str, ...] = ("numpy", "torch", "cuda")
_DEVICE_BACKENDS: Tuple[str, ...] = ("torch", "cuda")
# storage dtype name -> backends allowed to execute it
SUPPORTED_DTYPES: Dict[str, Tuple[str, ...]] = {
    "float64": _ALL_BACKENDS,
    "float32": _ALL_BACKENDS,
    "float16": _DEVICE_BACKENDS,
    "bfloat16": _DEVICE_BACKENDS,
}

TORCH_DTYPES: Dict[str, torch.dtype] = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}
_NAMES: Dict[torch.dtype, str] = {v: k for k, v in TORCH_DTYPES.items()}
# integer storage types the routines take beside the registry (numpy's
# names, which name the groups)
INTEGER_DTYPES: Dict[str, torch.dtype] = {
    "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64,
}
_INT_NAMES: Dict[torch.dtype, str] = {v: k
                                      for k, v in INTEGER_DTYPES.items()}


def dtype_name(dtype) -> str:
    """The name of a supported or integer dtype (any spelling)."""
    dt = storage_dtype(dtype)
    return _NAMES.get(dt) or _INT_NAMES[dt]


def storage_dtype(dtype) -> torch.dtype:
    """:func:`canonical_dtype`, integer types included: the dtype of a
    matrix or a group, where the registry gates only what a caller may
    ask for."""
    if isinstance(dtype, torch.dtype) and dtype in _INT_NAMES:
        return dtype
    name = str(dtype).replace("torch.", "")
    if name not in INTEGER_DTYPES and name not in SUPPORTED_DTYPES:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            pass
    return INTEGER_DTYPES.get(name) or canonical_dtype(dtype)


def is_integer(dtype) -> bool:
    return storage_dtype(dtype) in _INT_NAMES


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
            f"(supported there: "
            f"{sorted(n for n, b in SUPPORTED_DTYPES.items() if backend in b)}; "
            f"{name} needs one of {list(allowed)})")
    return dt


def promote_dtypes(a, b) -> torch.dtype:
    """The reference's ``promote_dtypes``: ``np.promote_types`` over two
    supported or integer dtypes (int64 x float32 is float64, int8 x
    float16 float16, int64 x int32 int64).  Pairs with no common
    precision raise, as numpy refuses them: bfloat16 x float16, where
    torch would silently widen to float32, and bfloat16 with an integer
    wider than 8 bits (ml_dtypes' table)."""
    da, db = storage_dtype(a), storage_dtype(b)
    if da == db:
        return da
    pair = {da, db}
    if torch.bfloat16 in pair:
        other = (pair - {torch.bfloat16}).pop()
        if other in (torch.float32, torch.float64):
            return other
        if other in (torch.int8, torch.uint8):
            return torch.bfloat16
    else:
        return storage_dtype(np.promote_types(dtype_name(da),
                                              dtype_name(db)).name)
    raise ValueError(
        f"no common precision between {dtype_name(da)} and "
        f"{dtype_name(db)} operands; pass an explicit dtype=")


def accumulator_dtype(dtype) -> torch.dtype:
    """float64 and the integers accumulate in float64, every narrower
    float in float32."""
    dt = storage_dtype(dtype)
    return torch.float64 if dt == torch.float64 or dt in _INT_NAMES \
        else torch.float32
