"""Multi-host bootstrap: 2 separate processes, one global 8-device mesh.

Each subprocess runs 4 virtual CPU devices and joins a
`jax.distributed` process group over localhost; the Z-sharded JFA then
executes over the 2-process global mesh and every process's local
shards must match the single-process result. This is the CPU stand-in
for a 2-host run (SURVEY.md §5: the reference has no distributed
backend at all; `jax.distributed.initialize` is the replacement here).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from jax.sharding import PartitionSpec as P

sys.path.insert(0, os.getcwd())  # launched with cwd = repo root
from voxtpu.grids.voxel_grid import GridSpec
from voxtpu.ops.jfa import jfa_xla
from voxtpu.parallel.distributed import (global_from_local, global_mesh,
                                         init_distributed, local_from_global)
from voxtpu.parallel.sharded_jfa import jfa_sharded

port, pid = sys.argv[1], int(sys.argv[2])
idx, count = init_distributed(f"localhost:{port}", 2, pid)
assert (idx, count) == (pid, 2), (idx, count)
assert jax.device_count() == 8, jax.device_count()
assert len(jax.local_devices()) == 4

n = 32
spec = GridSpec(n=n, origin=(0.5, 0.0, -1.0), voxel_size=1.0 / n)
zz, yy, xx = np.indices((n, n, n))
c = (n - 1) / 2
occ = ((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2 <= (n * 0.35) ** 2)

mesh = global_mesh(("d", "z"), (1, 8))
# Data ingest: each process contributes only its half of the grid.
half = occ[pid * (n // 2):(pid + 1) * (n // 2)]
gocc = global_from_local(half, mesh, P("z", None, None))
assert gocc.shape == (n, n, n)

sdf = jfa_sharded(gocc, spec, mesh, encoding="wide")

# Every process checks its local shards against the (replicated)
# single-device flood.
expected = np.asarray(jfa_xla(occ, spec.origin, spec.voxel_size, n=n,
                              encoding="wide"))
shards = local_from_global(sdf)
assert len(shards) == 4, len(shards)
for index, data in shards:
    np.testing.assert_allclose(data, expected[index], rtol=1e-6, atol=0)

# And the packed encoding over the same group.
sdf_p = jfa_sharded(gocc, spec, mesh, encoding="packed")
expected_p = np.asarray(jfa_xla(occ, spec.origin, spec.voxel_size, n=n,
                                encoding="packed"))
for index, data in local_from_global(sdf_p):
    np.testing.assert_allclose(data, expected_p[index], rtol=1e-6, atol=0)

# Triangle-sharded voxelization over the cross-process mesh (ring
# exchange): every process's slabs must equal the single-device grid.
from voxtpu.mesh.generate import icosphere
from voxtpu.ops.vox import voxelize
from voxtpu.parallel.sharded_vox import voxelize_sharded

tri_mesh = icosphere(3)
vspec = GridSpec.fit(tri_mesh.coords, 32)
single_words = np.asarray(voxelize(tri_mesh, vspec, backend="xla").words)
gw = voxelize_sharded(tri_mesh, vspec, mesh).words
for index, data in local_from_global(gw):
    np.testing.assert_array_equal(data, single_words[index])

print(f"WORKER{pid} OK")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_workers():
    """Spawn the 2-process worker pair (non-blocking).

    Called from `conftest.pytest_collection_modifyitems` at collection
    time so the ~4 min of subprocess wall-clock overlaps the rest of
    the suite (the test itself is moved to the end of the run and just
    joins + asserts); falls back to a same-test launch when the file
    runs alone."""
    import tempfile

    worker = os.path.join(tempfile.mkdtemp(prefix="voxtpu_dist_"),
                          "worker.py")
    with open(worker, "w") as f:
        f.write(_WORKER)
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    return [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(pid)],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]


def test_two_process_mesh_jfa(request):
    procs = getattr(request.config, "_voxtpu_dist_workers", None)
    if procs is None:
        procs = launch_workers()
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"WORKER{pid} OK" in out
