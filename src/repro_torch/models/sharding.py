"""Sharding rules of the model stack, without a mesh.

The counterpart of the reference's ``models/sharding.py``, which maps
*logical* axes of parameters and activations (batch, seq, embed, model,
expert, kv) to mesh axes.  The port runs on one card, so the only rules
are ``NO_MESH``: ``constrain`` is the identity.  A mesh comes with the
multi-device slice (``torch.distributed`` over several cards, with the
ring collectives of ``core/distributed.py``); until then
``rules_for_mesh`` raises for any mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

# what a mesh needs, named in every refusal of one
MULTI_DEVICE = ("it comes with the multi-device slice (core/distributed.py "
                "and the meshes)")


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Optional[Any] = None

    def constrain(self, x: torch.Tensor, *logical) -> torch.Tensor:
        """The identity: with no mesh there is nothing to constrain."""
        return x


def rules_for_mesh(mesh, *, seq_axis: Optional[str] = None) -> MeshRules:
    if mesh is None:
        return NO_MESH
    raise NotImplementedError(
        f"the port runs the model stack on one card; a mesh: {MULTI_DEVICE}")


NO_MESH = MeshRules()
