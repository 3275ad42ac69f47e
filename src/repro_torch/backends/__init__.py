"""Pluggable execution backends for the port's BLASX runtime.

``create_backend(name)`` is the factory the runtime uses; selection is
threaded through ``RuntimeConfig(backend=...)`` and
``BlasxContext(backend=...)``.

  * ``torch`` — a whole step group in one batched ``torch.matmul``
                (the reference's ``jax`` backend);
  * ``cuda``  — full-fill groups through the hand-written kernel,
                everything else via the torch path (the reference's
                ``pallas`` backend).
"""
from __future__ import annotations

from typing import Dict, Type

from .base import ExecutionBackend, GroupResult, StepGroupKey
from .cuda_backend import CudaBackend
from .torch_backend import TorchBackend

BACKENDS: Dict[str, Type[ExecutionBackend]] = {
    "torch": TorchBackend,
    "cuda": CudaBackend,
}


def available_backends():
    return tuple(BACKENDS)


def create_backend(name: str) -> ExecutionBackend:
    try:
        cls = BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; expected one of {tuple(BACKENDS)}"
        ) from None
    return cls()


__all__ = [
    "ExecutionBackend", "GroupResult", "StepGroupKey",
    "TorchBackend", "CudaBackend",
    "BACKENDS", "available_backends", "create_backend",
]
