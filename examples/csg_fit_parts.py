#!/usr/bin/env python
"""Gradients through CSG booleans: fit several part meshes at once.

The BASELINE north-star composition (CSG union of two meshes, SDF-ready
occupancy) made differentiable: both parts' vertices are perturbed, then
descended together against the soft-IoU loss of the SOFT CSG composition
vs the hard union target. The CUDA reference can only compose hard bit
grids (`csg/csg.h:14-30`); here subgradients flow through the min/max
boolean into every part simultaneously.

    python examples/csg_fit_parts.py [--n 48] [--steps 60] [--noise 0.01]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh-a", default="sphere",
                    help="generated mesh name or .obj path")
    ap.add_argument("--mesh-b", default="d20",
                    help="generated mesh name or .obj path")
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--lr", type=float, default=5e-3)
    args = ap.parse_args()

    import jax.numpy as jnp
    import numpy as np

    from voxtpu import GridSpec
    from voxtpu.mesh.generate import mesh_by_name
    from voxtpu.models.csg_fit import CSGFit, CSGPart
    from voxtpu.ops.csg import csg
    from voxtpu.ops.soft_vox import make_soft_plan
    from voxtpu.ops.vox import voxelize

    mesh_a = mesh_by_name(args.mesh_a)
    mesh_b = mesh_by_name(args.mesh_b)
    all_coords = np.concatenate([mesh_a.coords, mesh_b.coords])
    spec = GridSpec.fit(all_coords, args.n)

    # Hard union of the UNPERTURBED parts is the target.
    target = csg(voxelize(mesh_a, spec), voxelize(mesh_b, spec), "union")
    target_occ = target.to_dense().astype(jnp.float32)

    rng = np.random.default_rng(0)
    scale = float(np.ptp(all_coords, axis=0).max())
    noisy = [
        m.coords + rng.normal(0, args.noise * scale, m.coords.shape)
        .astype(np.float32)
        for m in (mesh_a, mesh_b)
    ]

    parts = [
        CSGPart(plan=make_soft_plan(
            type(mesh_a)(name="a", coords=noisy[0], faces=mesh_a.faces,
                         faces_normals=mesh_a.faces_normals), spec,
            pad_window=2), op="union"),
        CSGPart(plan=make_soft_plan(
            type(mesh_b)(name="b", coords=noisy[1], faces=mesh_b.faces,
                         faces_normals=mesh_b.faces_normals), spec,
            pad_window=2), op="union"),
    ]
    fit = CSGFit(parts, target_occ, learning_rate=args.lr)
    coords_list, opt_state = fit.init(noisy)
    l0 = float(fit.loss(coords_list))
    metrics = {"loss": l0}
    for i in range(args.steps):
        coords_list, opt_state, metrics = fit.step(coords_list, opt_state)
        if (i + 1) % max(1, args.steps // 6) == 0:
            print(f"step {i+1:4d}  loss={float(metrics['loss']):.4f}  "
                  f"refreshes={fit.refresh_count}", flush=True)
    l1 = float(metrics["loss"])
    print(f"soft-IoU loss: {l0:.4f} -> {l1:.4f} "
          f"({'improved' if l1 < l0 else 'NOT improved'})")
    return 0 if l1 < l0 else 1


if __name__ == "__main__":
    sys.exit(main())
