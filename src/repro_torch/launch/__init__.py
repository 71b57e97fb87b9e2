"""Device meshes for the DCNN paths (`launch.mesh`)."""
from .mesh import DeviceMesh, make_serving_mesh, make_test_mesh

__all__ = ["DeviceMesh", "make_serving_mesh", "make_test_mesh"]
