"""Meshes: the container, face connectivity, generators and readers.

Copied from hifiles_tpu/mesh/__init__.py (lines 1-5); the port also
exports the channel and mixed-mesh generators its bench cases use.
"""

from .core import MeshData, FaceConnectivity, build_faces
from .generate import (channel_hex_mesh, channel_prism_tet_mesh,
                       channel_quad_mesh, periodic_hex_mesh,
                       periodic_mixed_mesh_2d, periodic_prism_mesh,
                       periodic_quad_mesh, periodic_tet_mesh)

__all__ = ["MeshData", "FaceConnectivity", "build_faces",
           "channel_hex_mesh", "channel_prism_tet_mesh", "channel_quad_mesh",
           "periodic_hex_mesh", "periodic_mixed_mesh_2d",
           "periodic_prism_mesh", "periodic_quad_mesh", "periodic_tet_mesh"]
