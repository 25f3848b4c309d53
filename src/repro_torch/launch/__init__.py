"""Launch helpers of the port: the mesh of ranks (:mod:`.mesh`)."""
from .mesh import (Mesh, axis_index, gather_to_lead, make_mesh,
                   make_production_mesh, mesh_axis_sizes, psum)

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "axis_index",
           "mesh_axis_sizes", "psum", "gather_to_lead"]
