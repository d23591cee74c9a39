"""Differentiable soft voxelization — gradients w.r.t. vertex positions.

New capability beyond the CUDA reference (BASELINE.json north star): the
reference's XOR parity fill (`vox/sequential.cpp:56-57`) is not
differentiable — bits don't have gradients, and the parity of a count is
piecewise constant. We reformulate solid occupancy as a *signed winding
sum* along +X, which agrees with parity for closed oriented meshes and
admits a smooth relaxation:

    occ(x, y, z) = clip( sum_t  sgn(n_x^t) * cov_t(y, z) * H(x_hit^t - x) )

where cov_t is the product of the three (reference-oriented) edge
functions pushed through sigmoids, H is a sigmoid step along X, and
sgn(n_x) the triangle's facing. Crossings beyond the voxel along +X sum
to +1 inside a closed solid and 0 outside — exactly the reference's ray
parity, but smooth in every vertex coordinate.

Temperatures: `tau_edge` scales the edge functions (units: length^2),
`tau_x` the X step (units: length); both default to fractions of the
voxel size so sharpness is resolution-independent. As tau -> 0 the soft
grid converges to the hard parity grid (tested).

Implementation: the same host-side window bucketing as the hard path
(`voxtpu.ops.vox.FragmentPlan`), then a fragment -> (cell, X-profile)
accumulation with `jax.ops.segment_sum` (differentiable; its VJP is a
gather). O(fragments * N) work and memory: the (F, N) X-profile is the
largest intermediate, so grid size is bounded by device memory. On a
GPU the segment sum lowers to an atomic scatter-add.

Known non-smoothness (inherent to the winding formulation): a triangle
whose X-facing flips (n_x crossing 0) flips the SIGN of its whole
contribution — x_hit diverges and the step saturates, so the limit from
either side is +/-cov, a knife-edge discontinuity on the measure-zero
set {n_x = 0}. Meshes with exactly axis-aligned faces (icospheres,
boxes) sit on it; gradients are well-defined and correct everywhere
else. Finite-difference checks must use meshes in generic position.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from voxtpu.grids.voxel_grid import GridSpec
from voxtpu.mesh.mesh import Mesh
from voxtpu.ops.vox import FragmentPlan, _edge_zy


@functools.partial(jax.jit, static_argnames=("window", "n"))
def _soft_fragments(v0, v1, v2, start_y, start_z, *, window: int, n: int,
                    origin, voxel_size, tau_edge):
    """Per-bucket soft coverage: returns (cell, weight (F,), x_hit (F,))."""
    origin = jnp.asarray(origin, jnp.float32)
    vs = jnp.asarray(voxel_size, jnp.float32)
    tau_e = jnp.asarray(tau_edge, jnp.float32)

    def per_triangle(a, b, c, sy, sz):
        normal_x = (b[1] - a[1]) * (c[2] - b[2]) - (b[2] - a[2]) * (c[1] - b[1])
        sign = jnp.where(normal_x >= 0, jnp.float32(1), jnp.float32(-1))
        A, B, C = jnp.cross(b - a, c - a)
        D = A * a[0] + B * a[1] + C * a[2]

        dy = jax.lax.broadcasted_iota(jnp.int32, (window, window), 1)
        dz = jax.lax.broadcasted_iota(jnp.int32, (window, window), 0)
        ys = sy + dy
        zs = sz + dz
        cy = origin[1] + (ys.astype(jnp.float32) * vs + vs / 2)
        cz = origin[2] + (zs.astype(jnp.float32) * vs + vs / 2)

        e0 = _edge_zy(a[1], a[2], b[1], b[2], cy, cz) * sign
        e1 = _edge_zy(b[1], b[2], c[1], c[2], cy, cz) * sign
        e2 = _edge_zy(c[1], c[2], a[1], a[2], cy, cz) * sign
        cov = (
            jax.nn.sigmoid(e0 / tau_e)
            * jax.nn.sigmoid(e1 / tau_e)
            * jax.nn.sigmoid(e2 / tau_e)
        )
        in_grid = (ys >= 0) & (ys < n) & (zs >= 0) & (zs < n)

        safe_A = jnp.where(jnp.abs(A) < 1e-20, jnp.float32(1e-20), A)
        x_hit = (D - B * cy - C * cz) / safe_A
        degenerate = jnp.abs(A) < 1e-20
        weight = jnp.where(in_grid & ~degenerate, sign * cov, 0.0)
        cell = jnp.where(in_grid, zs * n + ys, n * n)
        return cell.reshape(-1), weight.reshape(-1), x_hit.reshape(-1)

    cells, weights, xhits = jax.vmap(per_triangle)(v0, v1, v2, start_y, start_z)
    return cells.reshape(-1), weights.reshape(-1), xhits.reshape(-1)


@functools.partial(jax.jit, static_argnames=("n",))
def _accumulate(cells, weights, x_hits, *, n: int, origin, voxel_size, tau_x):
    """sum_f weight_f * sigmoid((x_hit_f - cx)/tau_x) into (N*N, N) cells."""
    origin = jnp.asarray(origin, jnp.float32)
    vs = jnp.asarray(voxel_size, jnp.float32)
    tau = jnp.asarray(tau_x, jnp.float32)
    cx = origin[0] + (jnp.arange(n, dtype=jnp.float32) * vs + vs / 2)  # (N,)
    profile = weights[:, None] * jax.nn.sigmoid(
        (x_hits[:, None] - cx[None, :]) / tau
    )  # (F, N)
    acc = jax.ops.segment_sum(profile, cells, num_segments=n * n + 1)
    return acc[: n * n].reshape(n, n, n)


def soft_voxelize(
    coords: jnp.ndarray,
    plan: FragmentPlan,
    *,
    tau_edge_frac: float = 0.25,
    tau_x_frac: float = 0.5,
    clip: bool = True,
) -> jnp.ndarray:
    """Differentiable occupancy grid from vertex coordinates.

    `coords` is the (V, 3) float32 array being optimized; `plan` fixes the
    triangle bucketing (windows are geometry-dependent and must be rebuilt
    if vertices move across voxel rows — standard practice is to refresh
    the plan every few optimization steps).
    """
    spec = plan.spec
    vs = spec.voxel_size
    tau_e = tau_edge_frac * vs * vs
    tau_x = tau_x_frac * vs

    all_cells, all_w, all_x = [], [], []
    for bucket in plan.buckets:
        window = bucket[0]
        fi = bucket[6] if len(bucket) > 6 else None
        if fi is None:
            raise ValueError("plan must be built with keep_faces=True for soft vox")
        sy, sz = bucket[4], bucket[5]
        tri = coords[plan.faces_array[fi]]  # (T, 3, 3)
        cells, w, x = _soft_fragments(
            tri[:, 0], tri[:, 1], tri[:, 2], sy, sz,
            window=window, n=spec.n,
            origin=spec.origin, voxel_size=vs,
            tau_edge=tau_e,
        )
        all_cells.append(cells)
        all_w.append(w)
        all_x.append(x)
    if not all_cells:  # zero-face mesh: one inert sentinel fragment
        all_cells = [jnp.full((1,), spec.n * spec.n, jnp.int32)]
        all_w = [jnp.zeros((1,), jnp.float32)]
        all_x = [jnp.zeros((1,), jnp.float32)]
    cells = jnp.concatenate(all_cells)
    w = jnp.concatenate(all_w)
    x = jnp.concatenate(all_x)
    occ = _accumulate(cells, w, x, n=spec.n, origin=spec.origin,
                      voxel_size=vs, tau_x=tau_x)
    if clip:
        occ = jnp.clip(occ, 0.0, 1.0)
    return occ


def make_soft_plan(mesh: Mesh, spec: GridSpec, pad_window: int = 1) -> FragmentPlan:
    """FragmentPlan variant that records face indices per bucket so
    vertex coordinates stay differentiable inputs (the plan holds only
    integer routing data). `pad_window` widens raster windows so sigmoid
    tails and small vertex motions stay covered (1 voxel suffices at the
    default temperatures — the edge sigmoids saturate within a fraction
    of a voxel; raise it when optimizing with wide taus, fragment count
    grows ~quadratically with it)."""
    plan = FragmentPlan.__new__(FragmentPlan)
    plan.spec = spec
    plan.faces_array = jnp.asarray(mesh.faces)
    from voxtpu.ops.vox import _pad_rows, _triangle_windows
    import numpy as np

    v0, v1, v2, start_y, start_z, w = _triangle_windows(mesh, spec)
    # Window width may exceed N by the padding: starts are shifted down
    # by pad//2, and capping w at N would drop the grid's last rows for
    # full-span triangles (out-of-grid candidates are masked away by the
    # in_grid test in _soft_fragments, so over-wide windows are safe).
    #
    # Odd pads have one leftover cell after the symmetric pad//2 split;
    # it goes, PER AXIS, to the side whose base window has less slack
    # (the base floor/ceil gives each side between -0.5 and +0.5 cells
    # of coverage beyond the bbox; always spending the odd cell on the
    # high side left the low side with zero guaranteed drift coverage —
    # code-review find). frac_low + frac_high < 1 <=> the low side is
    # the tighter one.
    w_cap = spec.n + pad_window
    w = np.minimum(w + pad_window, w_cap)
    shift_y = np.full(len(w), pad_window // 2, np.int64)
    shift_z = shift_y.copy()
    if pad_window % 2:
        oy, oz = np.float32(spec.origin[1]), np.float32(spec.origin[2])
        vs_np = np.float32(spec.voxel_size)

        def _extra_low(lo, hi, o):
            t_lo = (lo - o) / vs_np
            t_hi = (hi - o) / vs_np
            return ((t_lo - np.floor(t_lo)) + (t_hi - np.floor(t_hi))
                    < 1.0)

        ys = (v0[:, 1], v1[:, 1], v2[:, 1])
        zs = (v0[:, 2], v1[:, 2], v2[:, 2])
        shift_y += _extra_low(np.minimum(np.minimum(*ys[:2]), ys[2]),
                              np.maximum(np.maximum(*ys[:2]), ys[2]), oy)
        shift_z += _extra_low(np.minimum(np.minimum(*zs[:2]), zs[2]),
                              np.maximum(np.maximum(*zs[:2]), zs[2]), oz)
    start_y = np.maximum(start_y - shift_y, -pad_window)
    start_z = np.maximum(start_z - shift_z, -pad_window)
    plan.buckets = []
    # Same fine window ladder as the hard path (1,2,3,4,6,8,12,...):
    # with pad_window=1 most triangles land at W=3, which pure pow2
    # bucketing rounded to 16-cell windows — 44% wasted raster slots.
    from voxtpu.ops.vox import _pad_granular, _window_classes

    classes = _window_classes(max(int(w.max(initial=1)), 1))
    lo = 0
    for wclass in classes:
        sel = (w > lo) & (w <= wclass)
        idx = np.nonzero(sel)[0]
        if idx.size:
            pad = _pad_granular(idx.size)
            plan.buckets.append(
                (
                    int(min(wclass, w_cap)),
                    None, None, None,
                    jnp.asarray(_pad_rows(start_y[idx], pad, fill=spec.n)),
                    jnp.asarray(_pad_rows(start_z[idx], pad, fill=spec.n)),
                    jnp.asarray(_pad_rows(idx.astype(np.int32), pad, fill=0)),
                )
            )
        lo = wclass
    plan.num_fragments = sum(
        b[4].shape[0] * min(b[0], w_cap) ** 2 for b in plan.buckets
    )
    plan.pad_window = pad_window
    plan.plan_coords = np.asarray(mesh.coords, np.float32)
    return plan


def refresh_soft_plan(plan: FragmentPlan, coords) -> FragmentPlan:
    """Rebuild a soft plan's raster windows for moved vertices.

    The bucket windows are geometry-dependent: once any vertex drifts
    further than the plan's pad window, fragments fall outside their
    raster windows and coverage silently erodes. This rebuilds the same
    plan (same spec / faces / pad) from the current coordinates;
    `VoxelFit.maybe_refresh_plan` calls it automatically."""
    import numpy as np

    from voxtpu.mesh.mesh import Mesh

    faces = np.asarray(plan.faces_array)
    mesh = Mesh(name="refresh", coords=np.asarray(coords, np.float32),
                faces=faces, faces_normals=faces)
    return make_soft_plan(mesh, plan.spec,
                          pad_window=getattr(plan, "pad_window", 1))
