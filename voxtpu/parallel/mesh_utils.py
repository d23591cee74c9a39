"""Device-mesh helpers for sharded voxelization / JFA / training.

The reference is strictly single-process, single-GPU
(`cudaSetDevice(0)`, `apps/cli/main.cpp:22-23`; SURVEY.md §2d) — this
subsystem is new capability. Axis conventions:

- ``"d"`` — triangle/data axis (DP analog): meshes' triangle sets are
  sharded; occupancy contributions combine with an XOR- or sum-reduce.
- ``"z"`` — grid axis (SP/CP analog): voxel grids are sharded along Z
  (the outermost, contiguous array axis); JFA flood steps exchange
  k-halos along it with `ppermute` over NVLink.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, grid_axis: int | None = None) -> Mesh:
    """Build a (d, z) mesh. `grid_axis` fixes the z-axis size; by default
    the devices are split as evenly as possible with z as large as the
    grid sharding benefits from."""
    devices = np.asarray(jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    n = devices.size
    if grid_axis is None:
        # favor a square-ish split, z first
        grid_axis = 1
        for cand in (8, 4, 2, 1):
            if n % cand == 0 and cand <= n:
                grid_axis = cand
                break
    if n % grid_axis != 0:
        raise ValueError(f"{n} devices not divisible by grid axis {grid_axis}")
    return Mesh(devices.reshape(n // grid_axis, grid_axis), ("d", "z"))


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """Voxel/SDF grids shard their leading (Z) axis over the mesh z axis."""
    return NamedSharding(mesh, P("z", None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
