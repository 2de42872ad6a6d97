"""repro_torch.launch — device meshes for the PyTorch port
(:mod:`~repro_torch.launch.mesh`)."""

from .mesh import (Mesh, dp_axes, make_debug_mesh, make_production_mesh,
                   mesh_from_spec, model_axis)

__all__ = ["Mesh", "dp_axes", "make_debug_mesh", "make_production_mesh",
           "mesh_from_spec", "model_axis"]
