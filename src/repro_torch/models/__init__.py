"""Model stack of the port: the five families (dense, moe, ssm, hybrid,
encdec) on one device."""
from .sharding import MeshRules, rules_for_mesh, NO_MESH
from .transformer import Model, build_params

__all__ = ["Model", "build_params", "MeshRules", "rules_for_mesh", "NO_MESH"]
