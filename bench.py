#!/usr/bin/env python
"""Benchmark of the public entry points on a GPU.

    python bench.py [--ops vox jfa csg softvox] [--n 512 1024]
                    [--faces 1348128] [--iters 10]

Every op runs through the entry point a user calls, on the seeded bunny
stand-in (`voxtpu.mesh.generate.bunny`, 1,348,128 faces by default — the
reference's benchmark mesh size), timed on the host clock around
`block_until_ready`, median over `--iters` warm calls; compilation and
host plan builds are reported apart. One JSON line per (op, N), each
naming the device (platform, device kind, count) and the card's name and
power limit as nvidia-smi reports them:

- vox: `voxelize` with a prebuilt plan (the platform's resolve: the
  atomic-XOR kernel on a GPU), the same call with the plan build
  included, and the plain XLA sort-based resolve on the same fragments;
- jfa: `jfa`, plus one flood step alone against its byte bound (the
  packed int32 seed state read and written once);
- csg: a packed union against its byte bound (two grids read, one
  written);
- softvox: forward + backward of the soft-IoU loss through
  `soft_voxelize`.

Without a GPU it exits non-zero: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _vox(mesh, n, iters):
    import jax

    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.ops.vox import (FragmentPlan, fragments_from_plan,
                                resolve_fragments, uses_atomic_resolve,
                                voxelize)
    from voxtpu.utils.device import median_ms, timed

    spec = GridSpec.fit(mesh.coords, n)
    t0 = time.perf_counter()
    plan = FragmentPlan(mesh, spec)
    plan_s = time.perf_counter() - t0
    compile_s, times, words = timed(
        lambda: voxelize(mesh, spec, plan=plan).words, iters=iters)
    _, with_plan, _ = timed(lambda: voxelize(mesh, spec).words,
                            iters=max(1, iters // 5))
    _, plain, ref = timed(
        lambda: resolve_fragments(*fragments_from_plan(plan), n=n),
        iters=iters)
    assert bool(jax.numpy.array_equal(words, ref)), "resolve paths differ"
    return {"metric": f"vox_ms_{n}c_{mesh.num_faces}f",
            "value": median_ms(times), "unit": "ms",
            "resolve": "atomic" if uses_atomic_resolve() else "sort",
            "with_plan_build_ms": median_ms(with_plan),
            "xla_sort_resolve_ms": median_ms(plain),
            "plan_build_s": plan_s, "compile_s": compile_s,
            "fragments": plan.num_fragments}


def _occupancy(mesh, n):
    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.ops.vox import voxelize

    spec = GridSpec.fit(mesh.coords, n)
    return voxelize(mesh, spec), spec


def _jfa(mesh, n, iters, bw):
    import jax
    import jax.numpy as jnp

    from voxtpu.ops.jfa import _init_packed_jit, _step_packed_jit, jfa
    from voxtpu.utils.device import median_ms, timed

    grid, spec = _occupancy(mesh, n)
    compile_s, times, _ = timed(lambda: jfa(grid, spec), iters=iters)
    out = {"metric": f"jfa_ms_{n}c", "value": median_ms(times), "unit": "ms",
           "compile_s": compile_s, "flood_steps": n.bit_length() - 1}
    if n <= 1024:
        origin = jnp.asarray(spec.origin, jnp.float32)
        vs = jnp.float32(spec.voxel_size)
        seed = _init_packed_jit(grid.to_dense(), n=n)
        step_times = []
        for _ in range(iters + 1):  # the donated state feeds the next step
            t0 = time.perf_counter()
            seed = jax.block_until_ready(
                _step_packed_jit(seed, origin, vs, k=max(1, n // 8), n=n))
            step_times.append(time.perf_counter() - t0)
        step_ms = median_ms(step_times[1:])
        out["step_ms"] = step_ms
        bound_ms = 2 * n ** 3 * 4 / bw * 1e3 if bw else None
        out["step_byte_bound_ms"] = bound_ms
        out["step_byte_bound_share"] = bound_ms / step_ms if bw else None
    return out


def _csg(mesh, n, iters, bw):
    import jax.numpy as jnp

    from voxtpu.ops.csg import csg
    from voxtpu.utils.device import median_ms, timed

    grid, _ = _occupancy(mesh, n)
    other = grid.__class__(words=jnp.roll(grid.words, 1, axis=0),
                           origin=grid.origin, voxel_size=grid.voxel_size)
    _, times, _ = timed(lambda: csg(grid, other, "union").words, iters=iters)
    ms = median_ms(times)
    bound_ms = 3 * n ** 3 / 8 / bw * 1e3 if bw else None
    return {"metric": f"csg_union_ms_{n}c", "value": ms, "unit": "ms",
            "byte_bound_ms": bound_ms,
            "byte_bound_share": bound_ms / ms if bw else None}


def _softvox(mesh, n, iters):
    import jax
    import jax.numpy as jnp

    from voxtpu.models.fit import soft_iou_loss
    from voxtpu.ops.soft_vox import make_soft_plan, soft_voxelize
    from voxtpu.utils.device import median_ms, timed

    grid, spec = _occupancy(mesh, n)
    target = grid.to_dense().astype(jnp.float32)
    t0 = time.perf_counter()
    plan = make_soft_plan(mesh, spec)
    plan_s = time.perf_counter() - t0

    @jax.jit
    def fwd_bwd(coords, target):
        return jax.value_and_grad(
            lambda c: soft_iou_loss(soft_voxelize(c, plan), target))(coords)

    coords = jnp.asarray(mesh.coords)
    compile_s, times, _ = timed(fwd_bwd, coords, target, iters=iters)
    return {"metric": f"softvox_fwd_bwd_ms_{n}c_{mesh.num_faces}f",
            "value": median_ms(times), "unit": "ms",
            "soft_fragments": plan.num_fragments, "plan_build_s": plan_s,
            "compile_s": compile_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ops", nargs="+", default=["vox", "jfa", "csg", "softvox"],
                    choices=["vox", "jfa", "csg", "softvox"])
    ap.add_argument("--n", type=int, nargs="+", default=[512])
    ap.add_argument("--faces", type=int, default=1348128)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    from voxtpu.utils.cache import configure_compile_cache
    from voxtpu.utils.device import (HBM_BYTES_PER_S, NoGpuError, describe,
                                     nvidia_smi_name_power, peak_bytes,
                                     require_gpu)

    configure_compile_cache()
    try:
        dev = require_gpu()
    except NoGpuError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    device = describe()
    card = nvidia_smi_name_power()
    bw = HBM_BYTES_PER_S.get(dev.device_kind)
    print(f"# device={device} nvidia-smi: {card}", file=sys.stderr)

    from voxtpu.mesh.generate import bunny

    mesh = bunny(args.faces)
    for n in args.n:
        for op in args.ops:
            if op == "vox":
                out = _vox(mesh, n, args.iters)
            elif op == "jfa":
                out = _jfa(mesh, n, args.iters, bw)
            elif op == "csg":
                out = _csg(mesh, n, args.iters, bw)
            else:
                out = _softvox(mesh, n, args.iters)
            out.update({"device": device, "card": card,
                        "peak_bytes_in_use": peak_bytes()})
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
