"""Model stack of the port: the dense family (GQA + MLP blocks) so far."""
from .sharding import MeshRules, rules_for_mesh, NO_MESH
from .transformer import Model, build_params

__all__ = ["Model", "build_params", "MeshRules", "rules_for_mesh", "NO_MESH"]
