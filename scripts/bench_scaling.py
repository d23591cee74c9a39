#!/usr/bin/env python
"""Multi-device scaling benchmark: sharded vox / JFA / fit across mesh sizes.

North-star target (BASELINE.json): >= 80% scaling efficiency at 2 hosts.
On several cards this script measures it directly; without them it
runs on the CPU-simulated mesh (JAX_PLATFORMS=cpu +
--xla_force_host_platform_device_count) to validate the collective
structure and report the communication fractions. Strong scaling: fixed
N^3 grid, devices 1 -> D.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/bench_scaling.py --n 128 --devices 1 2 4 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def time_fn(fn, *args, iters=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.mesh.mesh import Mesh as TriMesh
    from voxtpu.mesh.generate import bunny
    from voxtpu.ops.soft_vox import make_soft_plan
    from voxtpu.ops.vox import FragmentPlan
    from voxtpu.parallel.sharded_fit import make_sharded_fit
    from voxtpu.parallel.sharded_jfa import jfa_sharded
    from voxtpu.parallel.sharded_vox import voxelize_sharded

    mesh = bunny()
    spec = GridSpec.fit(mesh.coords, args.n)
    plan = FragmentPlan(mesh, spec)
    soft_plan = make_soft_plan(mesh, spec)
    avail = jax.devices()
    print(f"# devices available: {len(avail)} ({avail[0].platform})")

    results = {}
    for d in args.devices:
        if d > len(avail) or args.n % max(d, 1) != 0:
            continue
        dm = Mesh(np.array(avail[:d]).reshape(1, d), ("d", "z"))

        t_vox = time_fn(lambda: voxelize_sharded(mesh, spec, dm, plan=plan),
                        iters=args.iters)

        grid = voxelize_sharded(mesh, spec, dm)
        occ = grid.to_dense()
        occ = jax.device_put(occ, NamedSharding(dm, P("z", None, None)))
        t_jfa = time_fn(lambda: jfa_sharded(occ, spec, dm), iters=args.iters)

        target = grid.to_dense().astype(np.float32)
        init_fn, step_fn, _ = make_sharded_fit(soft_plan, dm)
        target_slab = jax.device_put(
            np.asarray(target), NamedSharding(dm, P("z", None, None))
        )
        coords, opt = init_fn(mesh.coords)

        def step():
            c, o, loss = step_fn(coords, opt, target_slab)
            return loss

        t_fit = time_fn(step, iters=args.iters)
        results[d] = dict(vox_ms=t_vox * 1e3, jfa_ms=t_jfa * 1e3,
                          fit_ms=t_fit * 1e3)
        base = results[min(results)]
        eff = {
            k: base[k] / (results[d][k] * d / min(results))
            for k in base
        }
        print(f"devices={d}: vox={t_vox*1e3:.1f}ms jfa={t_jfa*1e3:.1f}ms "
              f"fit={t_fit*1e3:.1f}ms  strong-scaling eff vs {min(results)}dev: "
              + " ".join(f"{k.split('_')[0]}={eff[k]:.2f}" for k in eff),
              flush=True)

    print(json.dumps({"n": args.n, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
