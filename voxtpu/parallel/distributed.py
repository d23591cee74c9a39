"""Multi-host bootstrap: process groups, global meshes, global arrays.

The reference is strictly single-process/single-GPU (`cudaSetDevice(0)`,
`apps/cli/main.cpp:22-23`) — SURVEY.md §5 names `jax.distributed` as the
communication backend this framework provides instead.
Everything here is a thin, convention-setting layer over JAX's own
multi-controller runtime:

- `init_distributed()` wraps `jax.distributed.initialize`, honoring the
  standard env vars (cluster auto-detection) or explicit
  coordinator/process arguments (any cluster, including multi-process
  CPU tests).
- `global_mesh()` builds a `jax.sharding.Mesh` over every device of
  every process, topology-aware via `mesh_utils.create_device_mesh`.
- `global_from_local()` assembles a global sharded array from each
  process's host-local shard (the data-ingest pattern: each host loads
  only its slabs).

Usage (2 hosts)::

    # host 0                                   # host 1
    init_distributed("10.0.0.1:8476", 2, 0)    init_distributed("10.0.0.1:8476", 2, 1)
    mesh = global_mesh(("z",), (jax.device_count(),))
    occ = global_from_local(local_slab, mesh, P("z"))
    sdf = jfa_sharded(occ, spec, mesh)         # ppermute halos: NVLink/network

Every collective in `voxtpu.parallel` (`ppermute` JFA halos, `psum`
vertex-gradient all-reduce, fragment all-gathers) works unchanged on a
multi-process mesh — shard_map programs are single-controller-agnostic
by construction; only array ingest/egress (this module) differs.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None) -> tuple[int, int]:
    """Join (or bootstrap) the multi-process JAX runtime.

    With no arguments, defers to JAX's cluster auto-detection (SLURM /
    env vars `JAX_COORDINATOR_ADDRESS` etc.).
    Explicit arguments support arbitrary clusters and local multi-process
    tests. Idempotent: calling again after initialization is a no-op.

    Returns ``(process_index, process_count)``.
    """
    already = _client() is not None
    if not already:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    return jax.process_index(), jax.process_count()


def _client():
    from jax._src import distributed as _dist

    return getattr(_dist.global_state, "client", None)


def shutdown_distributed() -> None:
    """Tear down the process group (tests; optional at exit)."""
    if _client() is not None:
        jax.distributed.shutdown()


def global_mesh(axis_names: tuple[str, ...],
                axis_shape: tuple[int, ...] | None = None) -> Mesh:
    """Device mesh spanning ALL processes' devices.

    `axis_shape` defaults to putting every global device on the last
    axis (the "z" slab axis convention of `voxtpu.parallel`). Uses
    `mesh_utils.create_device_mesh`, which orders devices so that
    ICI-adjacent chips land on adjacent mesh coordinates and DCN hops
    only cross the slowest-varying axis.
    """
    from jax.experimental import mesh_utils

    n = jax.device_count()
    if axis_shape is None:
        axis_shape = (1,) * (len(axis_names) - 1) + (n,)
    if int(np.prod(axis_shape)) != n:
        raise ValueError(f"axis_shape {axis_shape} != device count {n}")
    devices = mesh_utils.create_device_mesh(axis_shape)
    return Mesh(devices, axis_names)


def global_from_local(local_data, mesh: Mesh, pspec: P,
                      global_shape: tuple[int, ...] | None = None):
    """Assemble a global sharded array from per-process host-local data.

    `local_data` holds this process's contiguous block of the global
    array along the sharded axes (all processes must pass consistent
    shapes). The single-process case degenerates to `jax.device_put`
    with the named sharding.
    """
    from jax.experimental import multihost_utils

    local_data = np.asarray(local_data)
    if jax.process_count() == 1:
        return jax.device_put(local_data, NamedSharding(mesh, pspec))
    return multihost_utils.host_local_array_to_global_array(
        local_data, mesh, pspec
    )


def local_from_global(garr):
    """This process's addressable shards of a global array, as
    (index, ndarray) pairs sorted by flat position — the egress dual of
    `global_from_local`."""
    shards = sorted(garr.addressable_shards,
                    key=lambda s: tuple(sl.start or 0 for sl in s.index))
    return [(s.index, np.asarray(s.data)) for s in shards]
