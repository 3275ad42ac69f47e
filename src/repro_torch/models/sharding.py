"""Logical-axis sharding rules (MaxText-style) for the model stack.

The counterpart of the reference's ``models/sharding.py``.  Parameters
and activations are annotated with *logical* axes; the rules map them to
the axes of a ``DeviceMesh``:

  single-pod  (16, 16)    ("data", "model")
  multi-pod   (2, 16, 16) ("pod", "data", "model")

``spec`` and ``fitted_sharding`` make the reference's per-dim axis
choices.  The port places nothing by them yet: each rank is one eager
process that holds every weight whole, its slice of the global batch
(batch axes), and every other activation dim at its global value.  A
sharded branch (``layers.row_parallel_matmul``, ``moe._moe_block_sharded``)
slices this rank's shard, computes, and combines with the collective the
reference names, so every rank again holds the global value; so
``constrain`` is the identity.  With no mesh every helper degrades to a
no-op.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..core.distributed import mesh_shape

# logical axis vocabulary
BATCH = "batch"       # global batch            -> ("pod","data") / ("data",)
SEQ = "seq"           # sequence (usually unsharded; CP uses it)
EMBED = "embed"       # d_model                 -> fsdp ("data")
MODEL = "model"       # TP dim (heads/ff/vocab) -> "model"
EXPERT = "expert"     # MoE experts             -> "model"
KV = "kv"             # kv heads                -> "model"


@dataclasses.dataclass(frozen=True)
class Placement:
    """A mesh and one physical axis (or tuple of axes, or None) a dim:
    the reference's ``NamedSharding``, recorded, not applied."""
    mesh: Any
    spec: Tuple


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Optional[Any] = None
    batch_axes: Tuple[str, ...] = ("data",)
    fsdp_axis: Optional[str] = "data"
    model_axis: Optional[str] = "model"
    seq_axis: Optional[str] = None   # context parallelism when set

    def axis_size(self, name) -> int:
        if self.mesh is None or name is None:
            return 1
        shape = mesh_shape(self.mesh)
        if isinstance(name, (tuple, list)):
            n = 1
            for a in name:
                n *= shape.get(a, 1)
            return n
        return shape.get(name, 1)

    def batch_size_divides(self, b: int) -> bool:
        return b % max(1, self.axis_size(self.batch_axes)) == 0

    def physical(self, logical: Optional[str]):
        if logical is None:
            return None
        if logical == BATCH:
            return self.batch_axes if len(self.batch_axes) > 1 \
                else self.batch_axes[0]
        if logical == SEQ:
            return self.seq_axis
        if logical == EMBED:
            return self.fsdp_axis
        if logical in (MODEL, EXPERT, KV):
            return self.model_axis
        raise ValueError(f"unknown logical axis {logical!r}")

    def spec(self, *logical) -> Tuple:
        return tuple(self.physical(lg) for lg in logical)

    def sharding(self, *logical) -> Optional[Placement]:
        if self.mesh is None:
            return None
        return Placement(self.mesh, self.spec(*logical))

    def fitted_sharding(self, shape, *logical) -> Optional[Placement]:
        """Like ``sharding`` but drops any axis that does not divide the
        corresponding dim (odd vocab sizes, few kv heads, batch=1...)."""
        if self.mesh is None:
            return None
        if len(shape) != len(logical):
            raise ValueError(f"shape {tuple(shape)} vs logical axes "
                             f"{logical}")
        fitted = []
        for dim, log in zip(shape, logical):
            ax = self.physical(log)
            n = self.axis_size(ax)
            fitted.append(ax if (ax is not None and n > 1
                                 and dim % n == 0) else None)
        return Placement(self.mesh, tuple(fitted))

    def constrain(self, x: torch.Tensor, *logical) -> torch.Tensor:
        """The identity: every rank already holds the value its
        placement would gather (see the module's docstring)."""
        return x

    def group(self, name: str):
        """The process group of mesh axis ``name``."""
        return self.mesh.get_group(name)

    def coordinate(self, name: str) -> int:
        """This rank's index along mesh axis ``name``."""
        return self.mesh.get_local_rank(name)


def rules_for_mesh(mesh, *, seq_axis: Optional[str] = None) -> MeshRules:
    if mesh is None:
        return NO_MESH
    names = tuple(mesh.mesh_dim_names)
    batch = tuple(n for n in names if n in ("pod", "data")) or (names[0],)
    fsdp = "data" if "data" in names else None
    model = "model" if "model" in names else None
    return MeshRules(mesh=mesh, batch_axes=batch, fsdp_axis=fsdp,
                     model_axis=model, seq_axis=seq_axis)


NO_MESH = MeshRules(mesh=None, batch_axes=(), fsdp_axis=None,
                    model_axis=None)
