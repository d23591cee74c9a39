"""Bit-packed voxel occupancy grid as a JAX pytree.

Equivalent of the reference's ``VoxelsGrid<T, device>``
(`vplib/src/grid/voxels_grid.h:31-278`): one bit per voxel, word type
``uint32``, with world-space origin and voxel-size metadata
(`voxels_grid.h:39-43,160-169`).

Layout: ``words[z, y, xw]`` where bit ``b`` of word ``xw`` is voxel
``x = 32*xw + b``. The reference packs bits over the *flat* index
``x + y*N + z*N*N`` (`voxels_grid.h:88-92,131-143`); for ``N % 32 == 0``
(asserted by the reference's own tiled JFA, `jfa/tiled.cu:247`) the two
layouts are word-for-word identical. We require ``N % 32 == 0`` for the
packed form; dense boolean grids support any N.

There is no `Bit` proxy with atomics (`voxels_grid.h:45-83`): XLA/Pallas
programs have no cross-program shared mutable state, so the XOR/OR/AND
bit updates of the reference become pure word-level array ops here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

WORD_BITS = 32


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static grid geometry: N voxels/side, world origin, voxel size.

    Mirrors the CLI's grid fit (`apps/cli/main.cpp:77-87`):
    ``voxel_size = longest_bbox_side / N``, origin = bbox min corner.
    """

    n: int
    origin: Tuple[float, float, float]
    voxel_size: float

    @staticmethod
    def fit(coords: np.ndarray, n: int) -> "GridSpec":
        from voxtpu.mesh.bounding_box import calculate_bounding_box

        side, (mins, _) = calculate_bounding_box(coords)
        return GridSpec(n=int(n), origin=tuple(float(v) for v in mins), voxel_size=side / n)

    @property
    def num_words(self) -> int:
        if self.n % WORD_BITS != 0:
            raise ValueError(f"packed grids require N % {WORD_BITS} == 0, got {self.n}")
        return self.n // WORD_BITS

    def voxel_corners(self, xp=jnp):
        """Per-axis corner coordinate vectors (origin + i*voxel_size)."""
        idx = xp.arange(self.n, dtype=xp.float32)
        return tuple(
            xp.asarray(self.origin[a], xp.float32) + idx * xp.float32(self.voxel_size)
            for a in range(3)
        )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class VoxelGrid:
    """words: (N, N, N/32) uint32 in [z, y, x-word] order + geometry."""

    words: jnp.ndarray
    origin: jnp.ndarray      # (3,) float32  (ox, oy, oz)
    voxel_size: jnp.ndarray  # () float32

    # -- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        return (self.words, self.origin, self.voxel_size), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    # -- constructors ----------------------------------------------------
    @classmethod
    def zeros(cls, spec: GridSpec) -> "VoxelGrid":
        return cls(
            words=jnp.zeros((spec.n, spec.n, spec.num_words), jnp.uint32),
            origin=jnp.asarray(spec.origin, jnp.float32),
            voxel_size=jnp.float32(spec.voxel_size),
        )

    @classmethod
    def from_dense(cls, occ, spec: GridSpec) -> "VoxelGrid":
        return cls(
            words=pack_bits(jnp.asarray(occ)),
            origin=jnp.asarray(spec.origin, jnp.float32),
            voxel_size=jnp.float32(spec.voxel_size),
        )

    # -- views -------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.words.shape[0]

    def to_dense(self) -> jnp.ndarray:
        """Unpack to a boolean (N, N, N) grid in [z, y, x] order."""
        return unpack_bits(self.words)

    def count(self) -> int:
        """Number of set voxels (popcount over all words). Host-only:
        forces a device sync and returns a Python int — use
        :meth:`count_traced` inside jitted code.

        Summed per Z-plane in int32 on device (each plane holds < 2^31
        bits for any practical N), then in int64 on host — a direct
        int64 device sum silently truncates to int32 when x64 is off.
        """
        per_plane = jnp.sum(_popcount32(self.words), axis=(1, 2),
                            dtype=jnp.int32)
        return int(np.asarray(per_plane, dtype=np.int64).sum())

    def count_traced(self) -> jnp.ndarray:
        """Traceable set-voxel count as a float32 scalar (usable under
        `jax.jit`, unlike :meth:`count`).

        N <= 1024: one int32 sum (exact — count <= N^3 = 2^30 < 2^31)
        converted to float32 at the end (<= 2^-24 relative, one
        rounding). N >= 2048 would wrap int32 on near-full grids
        (> 2^31 set voxels), so those use per-Z-plane int32 partials
        (exact: a plane holds <= N^2 <= 2^24 bits) reduced in float32 —
        a few more roundings (tree reduce: ~log2(N) ulps), never a
        wrap."""
        per_plane = jnp.sum(_popcount32(self.words), axis=(1, 2),
                            dtype=jnp.int32)
        if self.n <= 1024:
            return jnp.sum(per_plane, dtype=jnp.int32).astype(jnp.float32)
        return jnp.sum(per_plane.astype(jnp.float32))

    def spec(self) -> GridSpec:
        return GridSpec(
            n=self.n,
            origin=tuple(float(v) for v in np.asarray(self.origin)),
            voxel_size=float(self.voxel_size),
        )


def pack_bits(occ) -> jnp.ndarray:
    """(N, N, N) bool [z, y, x] -> (N, N, N/32) uint32 words."""
    n = occ.shape[-1]
    if n % WORD_BITS != 0:
        raise ValueError(f"packed grids require N % {WORD_BITS} == 0, got {n}")
    occ = occ.astype(jnp.uint32).reshape(*occ.shape[:-1], n // WORD_BITS, WORD_BITS)
    shifts = jnp.arange(WORD_BITS, dtype=jnp.uint32)
    return jnp.sum(occ << shifts, axis=-1, dtype=jnp.uint32)


def unpack_bits(words) -> jnp.ndarray:
    """(..., Nw) uint32 words -> (..., Nw*32) bool."""
    shifts = jnp.arange(WORD_BITS, dtype=jnp.uint32)
    bits = (words[..., None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS).astype(bool)


def _popcount32(x: jnp.ndarray) -> jnp.ndarray:
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (x * jnp.uint32(0x01010101)) >> 24
