"""Launch layer of the port: meshes, the training and serving drivers,
their steps and the 1F1B pipeline."""
from .mesh import make_mesh_for_devices, make_production_mesh

__all__ = ["make_production_mesh", "make_mesh_for_devices"]
