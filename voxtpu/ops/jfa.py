"""Jump Flooding Algorithm SDF — XLA backend.

Reformulation of the reference JFA
(`jfa/sequential.cpp:24-125` semantics; `jfa/naive.cu`, `jfa/tiled.cu`
performance paths):

- The flood stride sequence k = N/2, N/4, ..., 1 is *statically known*
  from N, so the host Python loop unrolls into one jitted graph of
  log2(N) steps with static-shift stencils (pad + slice, no gathers,
  no dynamic control flow). The reference launches one kernel per k
  from a host loop with full device-to-device grid copies in between
  (`jfa/naive.cu:160-174`, `jfa/tiled.cu:297-329`); here the ping-pong
  is just SSA dataflow and XLA fuses each step into a single pass.
- Seed positions: the reference carries a ``Grid<Position>`` of world
  coordinates (12 bytes/voxel). We carry a packed int32 *seed index*
  (flat voxel id) and recompute its corner coordinates on the fly —
  identical float32 values (origin + idx * voxel_size is exactly how the
  reference computed them at `jfa/sequential.cpp:31-33`), at 1/3 the
  memory traffic. Device-memory bandwidth bounds this op.

Output contract (== reference): float32 signed **squared** distance in
[z, y, x] order; surface seeds 0, interior positive, exterior negative;
unreached voxels keep +/-inf (caller init -inf, `apps/cli/main.cpp:200`).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

from voxtpu.grids.voxel_grid import GridSpec, VoxelGrid

_OFFSETS = tuple(
    (dz, dy, dx)
    for dz in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
    if not (dz == 0 and dy == 0 and dx == 0)
)


def _shift3(a, dz: int, dy: int, dx: int, fill):
    """out[i] = a[i + (dz,dy,dx)] with `fill` where out of bounds (static)."""
    pads = []
    slices = []
    for d, size in zip((dz, dy, dx), a.shape):
        lo = max(0, -d)
        hi = max(0, d)
        pads.append((lo, hi))
        slices.append(slice(hi, hi + size) if d >= 0 else slice(0, size))
    padded = jnp.pad(a, pads, constant_values=fill)
    return padded[tuple(slices)]


def _corner_coords(n: int, origin, vs):
    zz = jax.lax.broadcasted_iota(jnp.float32, (n, n, n), 0)
    yy = jax.lax.broadcasted_iota(jnp.float32, (n, n, n), 1)
    xx = jax.lax.broadcasted_iota(jnp.float32, (n, n, n), 2)
    return (origin[0] + xx * vs, origin[1] + yy * vs, origin[2] + zz * vs)


# Plain int, not jnp.int32(-1): a module-level device array would
# initialize the JAX backend as an import side effect.
_NO_SEED = -1


def _boundary_mask(occ):
    """Occupied voxels with >= 1 empty or out-of-grid 26-neighbor
    (reference seed rule, `jfa/sequential.cpp:24-64`)."""
    all_n = jnp.ones_like(occ)
    for dz, dy, dx in _OFFSETS:
        all_n &= _shift3(occ, dz, dy, dx, False)
    return occ & ~all_n


def jfa_init_seed(occ):
    """Seed detection returning the flood state as ONE packed int32 seed
    grid: 10-bit (z, y, x) fields for seeds, -1 where no seed is known.

    The 26-view flood loop is bound by re-reads of the state from device
    memory (each shifted view re-streams the whole array), so the
    winning layout is
    the *smallest possible state*: the sdf value is recomputable from
    the seed (8 flops) and does not travel between steps; validity is
    seed >= 0 (d2 of the -1 sentinel is forced to +inf).

    10-bit fields cap this encoding at N = 1024; `jfa_init_seed_wide`
    is the N <= 16384 variant (two int32 grids, 2x the memory traffic;
    the cap keeps squared voxel distances exact in int32).
    """
    n = occ.shape[0]
    boundary = _boundary_mask(occ)
    packed = (
        (jax.lax.broadcasted_iota(jnp.int32, (n, n, n), 0) << 20)
        | (jax.lax.broadcasted_iota(jnp.int32, (n, n, n), 1) << 10)
        | jax.lax.broadcasted_iota(jnp.int32, (n, n, n), 2)
    )
    return jnp.where(boundary, packed, _NO_SEED)


def _seed_d2(seed, origin, vs, px, py, pz):
    """Squared world distance voxel->seed; +inf for the -1 sentinel
    (world coords reconstructed exactly as the reference computes them,
    `jfa/sequential.cpp:31-33`: origin + idx * voxel_size, float32)."""
    mask10 = jnp.int32(0x3FF)
    sx = (seed & mask10).astype(jnp.float32)
    sy = ((seed >> 10) & mask10).astype(jnp.float32)
    sz = ((seed >> 20) & mask10).astype(jnp.float32)
    d2 = (
        (px - (origin[0] + sx * vs)) ** 2
        + (py - (origin[1] + sy * vs)) ** 2
        + (pz - (origin[2] + sz * vs)) ** 2
    )
    return jnp.where(seed < 0, jnp.float32(jnp.inf), d2)


# ---------------------------------------------------------------------------
# Wide seed encoding (N <= 16384): (hi, lo) = ((z << 16) | y, x)
# ---------------------------------------------------------------------------
#
# 10-bit packing caps the single-int32 state at N = 1024. For larger
# grids (whose memory wall is the sharded path's regime) the seed is a
# PAIR of int32 grids: hi = (z << 16) | y with hi = -1 as the no-seed
# sentinel, lo = x. Same HBM-minimal philosophy — the sdf still never
# travels between steps — at exactly 2x the packed traffic. 16-bit
# fields hold global coordinates directly, so the sharded path needs no
# halo re-basing when seeds cross device boundaries.
#
# CRITICAL — selection must be exactly reproducible: the state is two
# arrays, and XLA freely *rematerializes* the selection chain once per
# consumer fusion. If the winner were chosen by float32 world-space
# distance, re-running the same expression under a different fusion can
# contract FMAs differently, flip a near-tie `<`, and pick hi from seed
# A but lo from seed B — a "chimera" seed that exists nowhere (observed
# on XLA:CPU: ~1.6% of bunny@64 voxels ended closer-than-possible; an
# `optimization_barrier` on the mask does NOT stop the remat). The fix
# is structural: flood comparisons use INTEGER voxel-space squared
# distances (exact, deterministic under any recomputation; fits int32
# for N <= 16384 since 3*(N-1)^2 < 2^31), and the reference's float32
# world-space d2 is computed once from the final seed in the output
# pass, where no selection remains.

_MASK16 = 0xFFFF
_D2I_SENTINEL = 2**31 - 1  # int32 "+inf" for the no-seed state


def jfa_init_seed_wide(occ, z0=0):
    """Wide-encoding seed init. `z0` offsets the Z iota (sharded slabs
    store GLOBAL z; the caller passes axis_index * slab)."""
    shape = occ.shape
    boundary = _boundary_mask(occ)
    zz = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + jnp.asarray(z0, jnp.int32)
    yy = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    xx = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    hi = jnp.where(boundary, (zz << 16) | yy, _NO_SEED)
    lo = jnp.where(boundary, xx, 0)
    return hi, lo


def _seed_d2_wide(hi, lo, origin, vs, px, py, pz):
    """Squared world distance voxel -> wide seed; +inf for hi < 0.
    Float32, reference convention — OUTPUT pass only, never selection."""
    sx = lo.astype(jnp.float32)
    sy = (hi & _MASK16).astype(jnp.float32)
    sz = ((hi >> 16) & 0x7FFF).astype(jnp.float32)
    d2 = (
        (px - (origin[0] + sx * vs)) ** 2
        + (py - (origin[1] + sy * vs)) ** 2
        + (pz - (origin[2] + sz * vs)) ** 2
    )
    return jnp.where(hi < 0, jnp.float32(jnp.inf), d2)


def _int_coords(shape, z0=0):
    """Integer voxel coordinates (zz, yy, xx); z offset for Z-slabs."""
    zz = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + jnp.asarray(z0, jnp.int32)
    yy = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    xx = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    return zz, yy, xx


def _seed_d2i_wide(hi, lo, zz, yy, xx):
    """EXACT integer voxel-space squared distance (selection metric).
    Sentinel reads +inf; its garbage-field arithmetic may wrap, but the
    wrapped value is discarded by the where."""
    dx = xx - lo
    dy = yy - (hi & _MASK16)
    dz = zz - ((hi >> 16) & 0x7FFF)
    d2 = dx * dx + dy * dy + dz * dz
    return jnp.where(hi < 0, jnp.int32(_D2I_SENTINEL), d2)


def _flood_step_seed_wide(hi, lo, k: int, n: int, zz, yy, xx):
    """One JFA pass over the wide (hi, lo) state. Same neighbor order
    and strict-< tie-breaking as the packed step, but the comparison is
    the exact integer metric (see the chimera note above)."""
    phi = jnp.pad(hi, k, constant_values=_NO_SEED)
    plo = jnp.pad(lo, k, constant_values=0)

    def view(p, dz, dy, dx):
        return p[
            k + dz * k : k + dz * k + n,
            k + dy * k : k + dy * k + n,
            k + dx * k : k + dx * k + n,
        ]

    best_d2 = _seed_d2i_wide(hi, lo, zz, yy, xx)
    for dz, dy, dx in _OFFSETS:
        nhi = view(phi, dz, dy, dx)
        nlo = view(plo, dz, dy, dx)
        d2 = _seed_d2i_wide(nhi, nlo, zz, yy, xx)
        better = d2 < best_d2
        best_d2 = jnp.where(better, d2, best_d2)
        hi = jnp.where(better, nhi, hi)
        lo = jnp.where(better, nlo, lo)
    return hi, lo


def _flood_step_seed(seed, k: int, n: int, origin, vs, px, py, pz):
    """One JFA pass (`jfa/sequential.cpp:72-125`): scan 26 neighbors at
    stride k, keep the seed with minimum squared distance. Strict `<`
    with the reference's offset order preserves its tie-breaking."""
    # Pad once per step; the 26 neighbor views are then static slices of
    # the same buffer (XLA fuses slices into the elementwise min-chain).
    pseed = jnp.pad(seed, k, constant_values=_NO_SEED)

    def view(dz, dy, dx):
        return pseed[
            k + dz * k : k + dz * k + n,
            k + dy * k : k + dy * k + n,
            k + dx * k : k + dx * k + n,
        ]

    best_d2 = _seed_d2(seed, origin, vs, px, py, pz)
    for dz, dy, dx in _OFFSETS:
        nseed = view(dz, dy, dx)
        d2 = _seed_d2(nseed, origin, vs, px, py, pz)
        better = d2 < best_d2
        best_d2 = jnp.where(better, d2, best_d2)
        seed = jnp.where(better, nseed, seed)
    return seed


@functools.partial(jax.jit, static_argnames=("n", "encoding"))
def jfa_xla(occ, origin, voxel_size, *, n: int, encoding: str = "auto"):
    """Full JFA: init + statically unrolled flood over k = N/2 ... 1.

    encoding: "packed" (one 10-bit-field int32 grid, N <= 1024, the
    HBM-minimal fast layout), "wide" ((hi, lo) int32 pair, N <= 16384,
    2x traffic), or "auto" (packed where it fits). Like the reference
    (`jfa/naive.cu:160-174`), the only remaining limit is device memory.

    Output contract (== reference `jfa/sequential.cpp`): signed squared
    world-space distance; surface seeds 0, interior +, exterior -,
    unreached interior +inf / exterior -inf (caller-init convention,
    `apps/cli/main.cpp:200`).
    """
    if encoding == "auto":
        encoding = "packed" if n <= 1024 else "wide"
    if encoding not in ("packed", "wide"):
        # A typo falling through to the packed branch would silently
        # corrupt seeds at n > 1024 (10-bit field collisions).
        raise ValueError(f"unknown encoding {encoding!r}; "
                         "use 'packed', 'wide' or 'auto'")
    if encoding == "packed" and n > 1024:
        raise ValueError("packed seeds are 10-bit fields (N <= 1024); "
                         "use encoding='wide' or 'auto'")
    if n > 16384:
        raise ValueError("wide seeds compare exact int32 voxel distances "
                         "(N <= 16384)")
    origin = jnp.asarray(origin, jnp.float32)
    vs = jnp.asarray(voxel_size, jnp.float32)
    px, py, pz = _corner_coords(n, origin, vs)
    sign = jnp.where(occ, jnp.float32(1), jnp.float32(-1))
    if encoding == "wide":
        hi, lo = jfa_init_seed_wide(occ)
        zz, yy, xx = _int_coords((n, n, n))
        k = n // 2
        while k >= 1:
            hi, lo = _flood_step_seed_wide(hi, lo, k, n, zz, yy, xx)
            k //= 2
        return sign * _seed_d2_wide(hi, lo, origin, vs, px, py, pz)
    seed = jfa_init_seed(occ)
    k = n // 2
    while k >= 1:
        seed = _flood_step_seed(seed, k, n, origin, vs, px, py, pz)
        k //= 2
    return sign * _seed_d2(seed, origin, vs, px, py, pz)


@functools.partial(jax.jit, static_argnames=("n",))
def _init_wide_jit(occ, *, n: int):
    return jfa_init_seed_wide(occ)


@functools.partial(jax.jit, static_argnames=("k", "n"),
                   donate_argnums=(0, 1))
def _step_wide_jit(hi, lo, *, k: int, n: int):
    zz, yy, xx = _int_coords((n, n, n))
    return _flood_step_seed_wide(hi, lo, k, n, zz, yy, xx)


@functools.partial(jax.jit, static_argnames=("n",))
def _final_wide_jit(hi, lo, occ, origin, vs, *, n: int):
    px, py, pz = _corner_coords(n, origin, vs)
    sign = jnp.where(occ, jnp.float32(1), jnp.float32(-1))
    return sign * _seed_d2_wide(hi, lo, origin, vs, px, py, pz)


@functools.partial(jax.jit, static_argnames=("n",))
def _init_packed_jit(occ, *, n: int):
    return jfa_init_seed(occ)


@functools.partial(jax.jit, static_argnames=("k", "n"),
                   donate_argnums=(0,))
def _step_packed_jit(seed, origin, vs, *, k: int, n: int):
    px, py, pz = _corner_coords(n, origin, vs)
    return _flood_step_seed(seed, k, n, origin, vs, px, py, pz)


@functools.partial(jax.jit, static_argnames=("n",))
def _final_packed_jit(seed, occ, origin, vs, *, n: int):
    px, py, pz = _corner_coords(n, origin, vs)
    sign = jnp.where(occ, jnp.float32(1), jnp.float32(-1))
    return sign * _seed_d2(seed, origin, vs, px, py, pz)


# Fence the step chain when one program's working set exceeds this many
# bytes: a runtime that allocates each ENQUEUED program's temp buffers
# at enqueue time lets a fast host queue all ~12 flood steps, whose
# select-chain temps then stack although every program alone fits.
# Whether the H100 runtime needs this is not measured yet.
_FENCE_BYTES = int(os.environ.get("JFA_FENCE_BYTES", str(2 * 1024 ** 3)))

# How many enqueued flood steps may have live temps at once. Depth d
# lets d steps' temp buffers coexist (~d x n^3 f32 extra memory at
# 1024^3) and overlaps each fence's round trip with the next step's
# execution. JFA_FENCE_DEPTH=1 is the minimum-memory schedule.
_FENCE_DEPTH = 2


def _fence_depth() -> int:
    # Read JFA_FENCE_DEPTH at call time; the module constant is the
    # fallback so tests can monkeypatch it.
    env = os.environ.get("JFA_FENCE_DEPTH")
    return max(1, int(env)) if env else _FENCE_DEPTH


def _fence(a) -> None:
    """Block until `a`'s producer has executed (scalar-sized D2H)."""
    jax.device_get(a[(0,) * a.ndim])


@jax.jit
def _fence_token(a):
    """Tiny non-donated scalar read of the flood state: a lagged fence
    holds this token instead of the state array itself, which the NEXT
    step's donation marks deleted (indexing it would raise)."""
    return a.reshape(-1)[0]


class _FenceWindow:
    """Fence enqueued flood steps so at most `depth` steps' temps are
    live at once (see `_FENCE_BYTES` / `_FENCE_DEPTH`)."""

    def __init__(self, active: bool, depth: int):
        self.active, self.depth = active, depth
        self.pending: list = []

    def push(self, state) -> None:
        if not self.active:
            return
        if self.depth <= 1:
            _fence(state)
            return
        self.pending.append(_fence_token(state))
        if len(self.pending) >= self.depth:
            jax.device_get(self.pending.pop(0))

    def drain(self) -> None:
        """Wait out every pending step — called before the final
        distance pass, whose own temps must not stack on step temps."""
        while self.pending:
            jax.device_get(self.pending.pop(0))


def jfa_xla_stepped(occ, origin, voxel_size, *, n: int):
    """JFA with per-step dispatch and donated flood state: one jit per
    flood step, so each step's buffers free before the next (a single
    whole-flood jit keeps every step's output live in XLA's buffer
    assignment — beyond device memory for the large grids this path
    exists for). N <= 1024 uses the packed one-int32 seed (donation
    makes a step's peak ~2 grids + fused temps); larger grids use the
    wide (hi, lo) encoding. Steps whose temps are
    large enough to stack under enqueue-ahead are fenced host-side (see
    `_FENCE_BYTES`). Single-chip memory is the only limit, as in the
    reference (`jfa/naive.cu:160`).
    """
    if n > 16384:
        raise ValueError("wide seeds compare exact int32 voxel distances "
                         "(N <= 16384)")
    origin = jnp.asarray(origin, jnp.float32)
    vs = jnp.asarray(voxel_size, jnp.float32)
    win = _FenceWindow(n ** 3 * 4 >= _FENCE_BYTES, _fence_depth())
    if n <= 1024:
        seed = _init_packed_jit(occ, n=n)
        k = n // 2
        while k >= 1:
            seed = _step_packed_jit(seed, origin, vs, k=k, n=n)
            win.push(seed)
            k //= 2
        win.drain()
        return _final_packed_jit(seed, occ, origin, vs, n=n)
    hi, lo = _init_wide_jit(occ, n=n)
    k = n // 2
    while k >= 1:
        hi, lo = _step_wide_jit(hi, lo, k=k, n=n)
        win.push(hi)
        k //= 2
    win.drain()
    return _final_wide_jit(hi, lo, occ, origin, vs, n=n)


def _use_stepped_xla(n: int, encoding: str) -> bool:
    """Above 1024 the wide encoding is mandatory and the single-jit
    flood OOMs (all step buffers live at once) — use per-step dispatch."""
    return n > 1024 and encoding in ("auto", "wide")


def jfa(grid: VoxelGrid | jnp.ndarray, spec: GridSpec | None = None,
        backend: str = "xla", encoding: str = "auto"):
    """Compute the signed squared distance field of an occupancy grid.

    Accepts a packed VoxelGrid or a dense bool array (+ spec).
    backend: "xla" (jitted stencils, any device), "reference" (NumPy
    oracle) or "native" (C++/OpenMP).
    `encoding` selects the seed layout for the xla backend ("auto":
    packed int32 up to N=1024, (hi, lo) wide pair beyond).
    """
    if isinstance(grid, VoxelGrid):
        occ = grid.to_dense()
        spec = grid.spec() if spec is None else spec
    else:
        occ = jnp.asarray(grid, bool)
        if spec is None:
            raise ValueError("spec required for dense input")

    if backend == "reference":
        from voxtpu.ops.reference import jfa_ref
        import numpy as np

        return jnp.asarray(jfa_ref(np.asarray(occ), spec))
    if backend == "native":
        from voxtpu.native import native_jfa
        import numpy as np

        return jnp.asarray(native_jfa(np.asarray(occ), spec))
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")
    if _use_stepped_xla(spec.n, encoding):
        # A single whole-flood jit keeps every step's buffers live in
        # XLA's buffer assignment and OOMs at the sizes that force the
        # wide encoding — route through per-step dispatch instead.
        return jfa_xla_stepped(occ, spec.origin, spec.voxel_size, n=spec.n)
    return jfa_xla(occ, spec.origin, spec.voxel_size, n=spec.n,
                   encoding=encoding)
