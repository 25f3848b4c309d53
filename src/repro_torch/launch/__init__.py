"""Launch helpers of the port: the mesh of ranks (:mod:`.mesh`) and the
step of an (arch x shape x mesh) cell (:mod:`.steps`, loaded on first use:
it imports the models, which import this package's mesh)."""
from .mesh import (Mesh, axis_index, gather_to_lead, make_mesh,
                   make_production_mesh, mesh_axis_sizes, pmax, pmean,
                   ppermute, psum)

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "axis_index",
           "mesh_axis_sizes", "psum", "pmax", "pmean", "ppermute",
           "gather_to_lead", "CellSpec", "build_cell", "make_runtime"]


def __getattr__(name):
    if name in ("CellSpec", "build_cell", "make_runtime"):
        from . import steps
        return getattr(steps, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
