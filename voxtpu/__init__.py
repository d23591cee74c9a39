"""voxtpu — differentiable mesh voxelization framework in JAX.

A JAX/XLA framework with the capabilities of the CUDA
reference `bigmat18/cuda-mesh-voxelization` (see SURVEY.md):

- Solid triangle-mesh voxelization into bit-packed occupancy grids
  (Schwarz-Seidel YZ rasterization + XOR parity fill, reformulated as
  fragment generation + a sort-based XOR resolve, or an atomic-XOR
  Pallas/Triton kernel on a GPU).
- CSG union/intersection/difference on packed voxel grids.
- Signed-distance fields via the Jump Flooding Algorithm as dense stencil
  sweeps (statically unrolled over k = N/2 ... 1).
- OBJ mesh import/export, grid->mesh / point-cloud exporters, CLI,
  profiling scopes and a benchmark harness.

Plus capabilities the CUDA reference lacks: a differentiable soft
voxelization path (gradients w.r.t. vertex positions) and multi-device
sharding over a `jax.sharding.Mesh` (triangle sharding with parity psum,
grid sharding with halo exchange for JFA).

Backend naming parity with the reference dispatch enum
(`vplib/src/proc_utils.h:7-9`):

==================  =========================================
reference backend    voxtpu backend
==================  =========================================
SEQUENTIAL (0)       "reference"  (NumPy oracle)
NAIVE      (1)       "xla"        (jax.numpy, any device)
TILED      (2)       "xla"        (on a GPU: atomic-XOR vox kernel)
OPENMP     (3)       "native"     (C++/OpenMP host library)
==================  =========================================
"""

from voxtpu.mesh.mesh import Mesh
from voxtpu.mesh.bounding_box import calculate_bounding_box
from voxtpu.mesh.obj_io import import_mesh, export_mesh
from voxtpu.grids.voxel_grid import VoxelGrid, GridSpec

__version__ = "0.1.0"

__all__ = [
    "Mesh",
    "VoxelGrid",
    "GridSpec",
    "calculate_bounding_box",
    "import_mesh",
    "export_mesh",
]
