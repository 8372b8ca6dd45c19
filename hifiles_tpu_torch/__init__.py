"""hifiles_tpu_torch: the PyTorch/CUDA port of hifiles_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference.  It carries
its own copies of the JAX package's numpy host layers (config/: the deck
parser and RunInput; mesh/: MeshData, face connectivity, generators and
readers; ops/: the operator builders; native/: the C++ mesh kernels) and
runs the time loop on a torch device, with the JAX package's Pallas kernels
written by hand in CUDA (csrc/).  It imports neither JAX nor hifiles_tpu.
"""

# Element type codes, matching ref:include/global.h:46-55 (CTYPE enum);
# copied from hifiles_tpu/__init__.py:22-29.  They come before the
# subpackage imports, which read them.
TRI = 0
QUAD = 1
TET = 2
PRISM = 3
HEX = 4

CTYPE_NAMES = {TRI: "tri", QUAD: "quad", TET: "tet", PRISM: "prism", HEX: "hex"}

from .config import RunInput  # noqa: E402
from .mesh import (MeshData, channel_hex_mesh,  # noqa: E402
                   channel_prism_tet_mesh, channel_quad_mesh,
                   periodic_hex_mesh, periodic_mixed_mesh_2d,
                   periodic_prism_mesh, periodic_quad_mesh, periodic_tet_mesh)
from .solver import MixedSolver, Solver  # noqa: E402

__all__ = ["CTYPE_NAMES", "HEX", "PRISM", "QUAD", "TET", "TRI", "MeshData",
           "MixedSolver", "RunInput", "Solver", "channel_hex_mesh",
           "channel_prism_tet_mesh", "channel_quad_mesh", "periodic_hex_mesh",
           "periodic_mixed_mesh_2d", "periodic_prism_mesh",
           "periodic_quad_mesh", "periodic_tet_mesh"]
