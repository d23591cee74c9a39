"""Command-line pipeline: import -> voxelize -> CSG -> SDF -> export.

Flag-for-flag equivalent of the reference CLI (`apps/cli/main.cpp:28-38`):

    python -m voxtpu.cli mesh1.obj [mesh2.obj ...] -n 128 -t 2 -p 1 -e -s

==========  ======================================================
flag         meaning (same semantics as the reference)
==========  ======================================================
filenames    input meshes (positional or -i)
-n           voxels per side (default 32)
-t           backend 0=reference 1=xla 2=xla 3=native (default 2;
             the reference maps 0..3 to sequential/naive/tiled/openmp;
             its naive and tiled kernels both map to the XLA path,
             whose vox resolve is the atomic-XOR kernel on a GPU)
-o           output filename (default out.obj)
-p           CSG op 0=void 1=union 2=intersection 3=difference
-e           export phase OBJs into out/
-s           compute SDF (JFA) on the folded grid
-m           benchmark iterations (>1 enables benchmark mode: only
             mesh[0] is voxelized each iteration and CSG-folded into a
             scratch grid, mirroring `apps/cli/main.cpp:89-188`)
==========  ======================================================

Profiling scopes print ``[Label]: X ms`` lines compatible with the
reference's stdout-scrape benchmark harness (`scripts/benchmarks.py:75`);
hierarchical sub-scopes use ``Parent::Child`` labels. Labels name the
path that ran: ``TritonVox`` where the atomic-XOR kernel resolved the
fragments, ``XlaVox`` where the sort-based resolve did.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

BACKENDS = {0: "reference", 1: "xla", 2: "xla", 3: "native"}
BACKEND_LABEL = {"reference": "Ref", "xla": "Xla", "native": "Native"}
CSG_OPS = {0: "void", 1: "union", 2: "intersection", 3: "difference"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="voxtpu", description="Mesh voxelization / CSG / SDF"
    )
    p.add_argument("filenames", nargs="*", help="input .obj meshes")
    p.add_argument("-i", dest="extra_filenames", action="append", default=[])
    p.add_argument("-n", "--num-voxels", type=int, default=32)
    p.add_argument("-t", "--type", type=int, default=2, choices=list(BACKENDS))
    p.add_argument("-o", "--output", default="out.obj")
    p.add_argument("-p", "--operation", type=int, default=0, choices=list(CSG_OPS))
    p.add_argument("-e", "--export", action="store_true")
    p.add_argument("-s", "--sdf", action="store_true")
    p.add_argument("-m", "--benchmark", type=int, default=1,
                   help="iterations; >1 enables benchmark mode")
    p.add_argument("--out-dir", default="out")
    p.add_argument("--device", default=None,
                   help="force jax platform (e.g. cpu)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a jax.profiler device trace into DIR")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    filenames = list(args.filenames) + list(args.extra_filenames)
    if not filenames:
        print("Need [input file]", file=sys.stderr)
        return 1
    import jax

    if args.device:
        jax.config.update("jax_platforms", args.device)

    from voxtpu.utils import profiling
    from voxtpu.utils.cache import configure_compile_cache

    configure_compile_cache()

    profiling.enable(True)

    if args.trace:
        from voxtpu.utils.trace import trace as device_trace

        with device_trace(args.trace):
            return _run_pipeline(args, filenames)
    return _run_pipeline(args, filenames)


def _run_pipeline(args, filenames) -> int:
    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.mesh.grid_to_mesh import (
        voxels_grid_to_mesh,
        voxels_grid_to_mesh_compressed,
        voxels_grid_to_point_cloud,
    )
    from voxtpu.mesh.obj_io import export_mesh, import_mesh
    from voxtpu.ops.csg import csg
    from voxtpu.ops.jfa import jfa
    from voxtpu.ops.vox import FragmentPlan, uses_atomic_resolve, voxelize
    from voxtpu.utils.profiling import ProfilingScope

    backend = BACKENDS[args.type]
    prefix = BACKEND_LABEL[backend]
    vox_label = ("TritonVox" if backend == "xla" and uses_atomic_resolve()
                 else f"{prefix}Vox")
    op = CSG_OPS[args.operation]
    iterations = max(1, args.benchmark)
    benchmark = iterations > 1
    do_export = args.export and not benchmark

    meshes = [import_mesh(f) for f in filenames]

    # Shared grid fit over all meshes (`apps/cli/main.cpp:65-87`).
    all_coords = np.concatenate([m.coords for m in meshes], axis=0)
    spec = GridSpec.fit(all_coords, args.num_voxels)

    grids = [None] * len(meshes)
    from voxtpu.grids.voxel_grid import VoxelGrid

    bm_grid = VoxelGrid.zeros(spec)

    # Per-(mesh, backend) plans are rebuilt every iteration inside the
    # profiled scope, mirroring the reference's per-call work-queue build
    # (`vox/tiled.cu:504-547`); planning/processing sub-scopes feed the
    # stage bar charts (scripts/plot_benchmarks.py).
    def _vox_profiled(mesh):
        if backend == "xla":
            with ProfilingScope(f"{vox_label}::planning"):
                plan = FragmentPlan(mesh, spec)
            with ProfilingScope(f"{vox_label}::processing") as pp:
                grid = voxelize(mesh, spec, backend=backend, plan=plan)
                pp.observe(grid.words)
            return grid
        return voxelize(mesh, spec, backend=backend)

    for _ in range(iterations):
        for i, mesh in enumerate(meshes):
            with ProfilingScope(f"{vox_label}({os.path.basename(mesh.name)})") as ps:
                grids[i] = _vox_profiled(mesh)
                ps.observe(grids[i].words)

            if do_export:
                occ = np.asarray(grids[i].to_dense())
                out_mesh = voxels_grid_to_mesh_compressed(occ, spec)
                export_mesh(
                    os.path.join(
                        args.out_dir,
                        f"{backend}_{os.path.basename(filenames[i])}",
                    ),
                    out_mesh,
                )

            if i > 0 or benchmark:
                other = grids[i] if not benchmark else bm_grid
                if op != "void":
                    with ProfilingScope(f"{prefix}CSG") as ps:
                        grids[0] = csg(grids[0], other, op, backend=backend)
                        ps.observe(grids[0].words)

            if benchmark:
                break

        if do_export and op != "void":
            occ = np.asarray(grids[0].to_dense())
            out_mesh = voxels_grid_to_mesh_compressed(occ, spec)
            export_mesh(
                os.path.join(args.out_dir, f"csg_vox_{backend}_{args.output}"),
                out_mesh,
            )

        if args.sdf:
            with ProfilingScope(f"{prefix}JFA") as ps:
                sdf = jfa(grids[0], spec, backend=backend)
                ps.observe(sdf)

            if do_export:
                occ = np.asarray(grids[0].to_dense())
                sdf_np = np.asarray(sdf)
                export_mesh(
                    os.path.join(args.out_dir, f"sdf_{backend}_{args.output}"),
                    voxels_grid_to_mesh(occ, sdf_np, spec),
                )
                export_mesh(
                    os.path.join(
                        args.out_dir, f"sdf_point_cloud_{backend}_{args.output}"
                    ),
                    voxels_grid_to_point_cloud(occ, sdf_np, spec),
                )

    return 0


if __name__ == "__main__":
    sys.exit(main())
