"""hifiles_tpu_torch: the PyTorch/CUDA port of hifiles_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference.  It takes
the JAX package's numpy host types (RunInput decks, MeshData meshes and
their generators, operator builders) and runs the time loop on a torch
device, with the JAX package's Pallas kernels written by hand in CUDA
(csrc/).  It never imports JAX.
"""

from hifiles_tpu.config import RunInput
from hifiles_tpu.mesh import MeshData, periodic_hex_mesh
from hifiles_tpu.mesh.generate import channel_hex_mesh

from .solver import Solver

__all__ = ["MeshData", "RunInput", "Solver", "channel_hex_mesh",
           "periodic_hex_mesh"]
