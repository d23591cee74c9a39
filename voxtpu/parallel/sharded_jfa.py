"""Multi-device JFA: Z-sharded grid with k-halo exchange (NVLink on GPUs).

The CP/ring-attention-shaped component of this framework (SURVEY.md §5
"long-context analog"): the voxel grid is sharded along Z; each flood
step at stride k needs the best-seed planes at z +/- k, which live at
most one device away while k <= slab thickness. Two regimes:

- **k < slab**: exchange k-plane halos with `jax.lax.ppermute` (up and
  down along the "z" mesh axis), then run the local 26-neighbor stencil
  on the halo-padded slab. Communication: 2 * k * N^2 * 4 bytes per
  state array.
- **k >= slab**: the step reaches across devices — but because k and
  slab are both powers of two, k is an exact whole-slab multiple, so
  the z +/- k planes of a local slab are precisely the FULL SLABS of
  devices idx -/+ k/slab. A strided `ppermute` (shift m = k/slab)
  fetches exactly those two slabs: 2 * slab * N^2 * 4 bytes per state
  array per step — vs the round-2 `all_gather` of the whole grid
  ((dz-1) * slab * N^2 * 4, i.e. dz/2 x more wire traffic; at 2048^3
  wide encoding on 8 devices that was 60.1 GB/step/device, now
  17.2 GB). A compacted seed-LIST exchange (boundary seeds ~ N^2) was
  considered and rejected: it changes the step into a brute-force
  nearest-seed scan (O(slab N^2 * |seeds|) compute), needs density
  thresholds, and the strided ppermute is already exact with the same
  per-voxel stencil cost.

State is the packed int32 seed grid (-1 = no seed) up to N = 1024 — the
memory-traffic-minimal formulation of `voxtpu.ops.jfa.jfa_xla` — and the
wide (hi, lo) int32 pair beyond (16-bit (z, y) fields + x plane,
N <= 16384): this is the path grids larger than one chip exist for, so
the cap is the encoding's field width, never 1024. Wide seeds store
GLOBAL coordinates (axis_index-derived Z at init), so halos need no
re-basing when a seed crosses a device boundary. On the wire a halo is
the state arrays only — the sdf is always recomputed from the seed.
Edge devices receive zero-filled halos from `ppermute` (no sender),
overridden to the no-seed sentinel (out-of-grid neighbors are "skipped"
in the reference, `jfa/sequential.cpp:96-101`; d2(sentinel) = +inf
loses every strict `<` comparison).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from voxtpu.grids.voxel_grid import GridSpec
from voxtpu.ops.jfa import (_OFFSETS, _int_coords, _seed_d2, _seed_d2_wide,
                            _seed_d2i_wide)

# Out-of-grid fill per state array. Selection metrics differ by
# encoding: packed (one array — immune to fusion-remat chimeras) keeps
# the reference's float32 world-space comparison; wide (two arrays)
# compares EXACT integer voxel distances so hi/lo can never be selected
# inconsistently under XLA rematerialization (see voxtpu/ops/jfa.py,
# "CRITICAL" note).
_FILLS = {"packed": (-1,), "wide": (-1, 0)}


def _halo_exchange(arr, k: int, axis_name: str, fill):
    """Concatenate [lower k planes from z-1 device, arr, upper k planes
    from z+1 device] along axis 0 inside shard_map."""
    nz = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    top = arr[-k:]     # goes to device idx+1 as its lower halo
    bottom = arr[:k]   # goes to device idx-1 as its upper halo
    up_perm = [(i, i + 1) for i in range(nz - 1)]
    down_perm = [(i + 1, i) for i in range(nz - 1)]
    lower = jax.lax.ppermute(top, axis_name, up_perm)      # from idx-1
    upper = jax.lax.ppermute(bottom, axis_name, down_perm)  # from idx+1
    if fill is not None:
        lower = jnp.where(idx == 0, jnp.full_like(lower, fill), lower)
        upper = jnp.where(idx == nz - 1, jnp.full_like(upper, fill), upper)
    return jnp.concatenate([lower, arr, upper], axis=0)


def _local_coords(n: int, slab: int, origin, vs, axis_name: str):
    z0 = (jax.lax.axis_index(axis_name) * slab).astype(jnp.float32)
    zz = jax.lax.broadcasted_iota(jnp.float32, (slab, n, n), 0) + z0
    yy = jax.lax.broadcasted_iota(jnp.float32, (slab, n, n), 1)
    xx = jax.lax.broadcasted_iota(jnp.float32, (slab, n, n), 2)
    return (origin[0] + xx * vs, origin[1] + yy * vs, origin[2] + zz * vs)


def _pad_yx(a, k: int, fill):
    return jnp.pad(a, ((0, 0), (k, k), (k, k)), constant_values=fill)


def _shift_yx(a, sy: int, sx: int, fill):
    """out[:, y, x] = a[:, y + sy, x + sx], `fill` outside the plane."""
    _, ny, nx = a.shape
    src = a[:, max(0, sy):ny + min(0, sy), max(0, sx):nx + min(0, sx)]
    return jax.lax.pad(src, jnp.asarray(fill, a.dtype),
                       ((0, 0, 0), (max(0, -sy), max(0, sy), 0),
                        (max(0, -sx), max(0, sx), 0)))


def _minimize(state, best_d2, views_fn, sel_fn, offsets=_OFFSETS):
    """Shared 26-neighbor minimization over a state tuple;
    views_fn(dz, dy, dx) -> state-tuple of shifted views;
    sel_fn(state) -> selection distance (encoding-specific)."""
    for dz, dy, dx in offsets:
        nstate = views_fn(dz, dy, dx)
        d2 = sel_fn(nstate)
        better = d2 < best_d2
        best_d2 = jnp.where(better, d2, best_d2)
        state = tuple(jnp.where(better, nv, v)
                      for nv, v in zip(nstate, state))
    return state, best_d2


def _step_local(state, fills, sel_fn, k: int, n: int, slab: int,
                axis_name: str):
    """One flood step on a Z-slab with k-halos (k < slab)."""
    padded = tuple(
        _pad_yx(_halo_exchange(s, k, axis_name, jnp.int32(f)), k,
                jnp.int32(f))
        for s, f in zip(state, fills)
    )

    def view(dz, dy, dx):
        sl = (slice(k + dz * k, k + dz * k + slab),
              slice(k + dy * k, k + dy * k + n),
              slice(k + dx * k, k + dx * k + n))
        return tuple(p[sl] for p in padded)

    return _minimize(state, sel_fn(state), view, sel_fn)[0]


def _fetch_slab(arr, shift: int, axis_name: str, fill):
    """The full slab of device idx+shift (sentinel fill past the edge)."""
    nz = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    perm = [(i, i - shift) for i in range(nz) if 0 <= i - shift < nz]
    got = jax.lax.ppermute(arr, axis_name, perm)
    src = idx + shift
    oob = (src < 0) | (src >= nz)
    return jnp.where(oob, jnp.full_like(got, fill), got)


def _strided_block(run, best_d2, old, dzb: int, fills, sel_fn, k: int,
                   n: int, slab: int, axis_name: str):
    """The 9 (dz = +/-1) or 8 (dz = 0) neighbours of one dz block of a
    k >= slab step: the old state's own slab (dz = 0) or the whole slab
    of device idx + dz * k/slab, folded into the running (state, best)."""
    shift = dzb * (k // slab)
    blk = tuple(
        _pad_yx(s if shift == 0
                else _fetch_slab(s, shift, axis_name, jnp.int32(f)),
                k, jnp.int32(f))
        for s, f in zip(old, fills))

    def view(dz, dy, dx):
        sl = (slice(0, slab),
              slice(k + dy * k, k + dy * k + n),
              slice(k + dx * k, k + dx * k + n))
        return tuple(p[sl] for p in blk)

    offsets = tuple(o for o in _OFFSETS if o[0] == dzb)
    if best_d2 is None:
        best_d2 = sel_fn(run)
    return _minimize(run, best_d2, view, sel_fn, offsets)


def _step_strided(state, fills, sel_fn, k: int, n: int, slab: int,
                  axis_name: str):
    """Flood step for k >= slab: k is an exact slab multiple (both are
    powers of two), so the z -/+ k neighbor planes are the whole slabs
    of devices idx -/+ k/slab — two strided `ppermute`s replace the
    round-2 full-grid `all_gather` (module docstring; dz/2 x less wire
    traffic, bit-identical results)."""
    run, best = state, None
    for dzb in (-1, 0, 1):  # the reference's offset order, dz outermost
        run, best = _strided_block(run, best, state, dzb, fills, sel_fn, k,
                                   n, slab, axis_name)
    return run


def comm_bytes_per_step(n: int, dz: int, encoding: str, k: int,
                        gathered: bool = False) -> int:
    """Per-device wire bytes for one flood step (analysis helper; the
    `gathered` flag reports the replaced round-2 all_gather path)."""
    arrays = len(_FILLS[encoding])
    slab = n // dz
    if k < slab:
        return 2 * k * n * n * 4 * arrays
    if gathered:
        return (dz - 1) * slab * n * n * 4 * arrays
    return 2 * slab * n * n * 4 * arrays


def _init_local(occ, n: int, slab: int, axis_name: str, encoding: str):
    """Seed detection on a Z-slab with a 1-voxel halo; state tuple out.
    Wide seeds store the GLOBAL z (slab offset from the mesh axis)."""
    hocc = _pad_yx(_halo_exchange(occ, 1, axis_name, False), 1, False)
    all_n = jnp.ones((slab, n, n), bool)
    for dz, dy, dx in _OFFSETS:
        all_n &= hocc[1 + dz : 1 + dz + slab, 1 + dy : 1 + dy + n,
                      1 + dx : 1 + dx + n]
    boundary = occ & ~all_n
    z0 = jax.lax.axis_index(axis_name).astype(jnp.int32) * slab
    zz = jax.lax.broadcasted_iota(jnp.int32, (slab, n, n), 0) + z0
    yy = jax.lax.broadcasted_iota(jnp.int32, (slab, n, n), 1)
    xx = jax.lax.broadcasted_iota(jnp.int32, (slab, n, n), 2)
    if encoding == "wide":
        hi = jnp.where(boundary, (zz << 16) | yy, jnp.int32(-1))
        lo = jnp.where(boundary, xx, 0)
        return hi, lo
    packed = (zz << 20) | (yy << 10) | xx
    return (jnp.where(boundary, packed, jnp.int32(-1)),)


def jfa_sharded(occ, spec: GridSpec, device_mesh: Mesh, axis_name: str = "z",
                encoding: str = "auto"):
    """Z-sharded JFA over a device mesh; returns the sharded SDF array.

    encoding: "packed" (N <= 1024, minimal wire/HBM traffic), "wide"
    (N <= 16384, 2x traffic), or "auto". Memory across the mesh is the
    only other limit, matching the reference's memory-bound JFA
    (`jfa/naive.cu:160-174`).
    """
    n = spec.n
    if encoding == "auto":
        encoding = "packed" if n <= 1024 else "wide"
    if encoding not in ("packed", "wide"):
        raise ValueError(f"unknown encoding {encoding!r}; "
                         "use 'packed', 'wide' or 'auto'")
    if encoding == "packed" and n > 1024:
        raise ValueError("packed seeds are 10-bit fields (N <= 1024); "
                         "use encoding='wide' or 'auto'")
    if n > 16384:
        raise ValueError("wide seeds compare exact int32 voxel distances "
                         "(N <= 16384)")
    dz = device_mesh.shape[axis_name]
    if n % dz != 0:
        raise ValueError(f"N={n} must divide by z axis {dz}")
    if dz & (dz - 1):
        # The strided k >= slab exchange fetches the slabs at idx -/+
        # k/slab, which is exact only when every such k is a whole slab
        # multiple — true iff dz is a power of two (k = n/2^j, slab =
        # n/dz). A dz like 6 would silently floor k//slab and flood from
        # the wrong planes.
        raise ValueError(f"z-axis device count must be a power of two "
                         f"(got {dz})")
    slab = n // dz
    if encoding == "wide":
        return _jfa_sharded_wide(occ, spec, device_mesh, axis_name, slab)
    fills = _FILLS["packed"]

    def fn(occ_slab):
        origin = jnp.asarray(spec.origin, jnp.float32)
        vs = jnp.float32(spec.voxel_size)
        state = _init_local(occ_slab, n, slab, axis_name, encoding)
        px, py, pz = _local_coords(n, slab, origin, vs, axis_name)
        sel_fn = lambda st: _seed_d2(st[0], origin, vs, px, py, pz)
        k = n // 2
        while k >= 1:
            step = _step_local if k < slab else _step_strided
            state = step(state, fills, sel_fn, k, n, slab, axis_name)
            k //= 2
        sign = jnp.where(occ_slab, jnp.float32(1), jnp.float32(-1))
        return sign * sel_fn(state)

    in_spec = P(axis_name, None, None)
    return jax.jit(
        jax.shard_map(
            fn, mesh=device_mesh,
            in_specs=(in_spec,), out_specs=in_spec,
            check_vma=False,
        )
    )(occ)


# z-planes per chunk of the wide flood (see `_jfa_sharded_wide`).
_CHUNK_PLANES = 16


def _flood_chunks(run, sources, dzs, fills, sel_fn, k: int, slab: int,
                  chunk: int):
    """Fold the neighbours whose dz is in `dzs` into the running state,
    `chunk` z-planes at a time. sources[dz] = (state tuple, z offset):
    neighbour (dz, dy, dx) of plane z is plane `offset + z` of that
    source, shifted by (dy k, dx k). `run` must not share a buffer with
    a source: it is updated in place."""
    offsets = tuple(o for o in _OFFSETS if o[0] in dzs)

    def body(c, run):
        z0 = c * chunk

        def cut(a, off):
            return jax.lax.dynamic_slice_in_dim(a, off + z0, chunk, 0)

        def view(dz, dy, dx):
            arrs, off = sources[dz]
            return tuple(_shift_yx(cut(a, off), dy * k, dx * k, f)
                         for a, f in zip(arrs, fills))

        sel = functools.partial(sel_fn, z0=z0)
        part = tuple(cut(r, 0) for r in run)
        part, _ = _minimize(part, sel(part), view, sel, offsets)
        return tuple(jax.lax.dynamic_update_slice_in_dim(r, p, z0, 0)
                     for r, p in zip(run, part))

    return jax.lax.fori_loop(0, slab // chunk, body, run)


def _jfa_sharded_wide(occ, spec: GridSpec, device_mesh: Mesh,
                      axis_name: str, slab: int):
    """Wide-encoding flood with one jit per step (per dz block for the
    k >= slab steps), the running state donated, and each step's
    neighbour views built `_CHUNK_PLANES` z-planes at a time, so a step
    holds little beyond the state, its halos and its copy. A whole-flood
    jit at 2048^3 on four H100s asked XLA for 256 GiB per card; one jit
    per step still for 72 GiB, the y/x-padded neighbour views being
    materialized (4x the state at k = N/2). The selection metric is exact integers, so folding the
    neighbours per block or per chunk gives the very result of the
    one-jit fold."""
    import math

    n = spec.n
    fills = _FILLS["wide"]
    z_spec = P(axis_name, None, None)
    chunk = math.gcd(slab, _CHUNK_PLANES)

    def sel_fn(state, z0=0):
        zs = jax.lax.axis_index(axis_name).astype(jnp.int32) * slab + z0
        zz, yy, xx = _int_coords(state[0].shape, zs)
        return _seed_d2i_wide(state[0], state[1], zz, yy, xx)

    def sharded(fn, n_in, n_out, donate=()):
        out = z_spec if n_out == 1 else (z_spec,) * n_out
        return jax.jit(jax.shard_map(fn, mesh=device_mesh,
                                     in_specs=(z_spec,) * n_in,
                                     out_specs=out, check_vma=False),
                       donate_argnums=donate)

    def local(hi, lo, k):
        haloed = tuple(_halo_exchange(s, k, axis_name, jnp.int32(f))
                       for s, f in zip((hi, lo), fills))
        sources = {dz: (haloed, k + dz * k) for dz in (-1, 0, 1)}
        return _flood_chunks((hi, lo), sources, (-1, 0, 1), fills, sel_fn,
                             k, slab, chunk)

    def block(run_hi, run_lo, old_hi, old_lo, k, dzb):
        old = (old_hi, old_lo)
        shift = dzb * (k // slab)
        src = old if shift == 0 else tuple(
            _fetch_slab(s, shift, axis_name, jnp.int32(f))
            for s, f in zip(old, fills))
        return _flood_chunks((run_hi, run_lo), {dzb: (src, 0)}, (dzb,),
                             fills, sel_fn, k, slab, chunk)

    def final(hi, lo, occ_slab):
        origin = jnp.asarray(spec.origin, jnp.float32)
        vs = jnp.float32(spec.voxel_size)
        px, py, pz = _local_coords(n, slab, origin, vs, axis_name)
        sign = jnp.where(occ_slab, jnp.float32(1), jnp.float32(-1))
        return sign * _seed_d2_wide(hi, lo, origin, vs, px, py, pz)

    hi, lo = sharded(lambda o: _init_local(o, n, slab, axis_name, "wide"),
                     1, 2)(occ)
    k = n // 2
    while k >= 1:
        if k < slab:
            hi, lo = sharded(functools.partial(local, k=k), 2, 2,
                             donate=(0, 1))(hi, lo)
        else:
            # The blocks read the old state, so the running state starts
            # as a copy of it; later blocks update that copy in place.
            run = tuple(jnp.copy(a) for a in (hi, lo))
            for dzb in (-1, 0, 1):
                run = sharded(functools.partial(block, k=k, dzb=dzb), 4, 2,
                              donate=(0, 1))(*run, hi, lo)
            hi, lo = run
        k //= 2
    return sharded(final, 3, 1)(hi, lo, occ)
