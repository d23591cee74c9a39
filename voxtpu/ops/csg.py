"""CSG booleans on voxel grids — hard (bit-packed) and soft (differentiable).

Hard path: word-wise fused elementwise ops on uint32-packed grids, the
exact analog of the reference functors ``el|=v``, ``el&=v``, ``el&=~v``
(`csg/csg.h:14-30`) applied thread-per-word (`csg/naive.cu:7-23`,
`csg/sequential.cpp:18-28`, `csg/openmp.cpp:21-31`). XLA emits it as
one memory-bound fused kernel — there is nothing to tile by hand.

Soft path (new capability per BASELINE.json): the same booleans on
float "occupancy probability" grids with subgradients, so gradients can
flow through CSG compositions of soft-voxelized meshes:
union = max, intersection = min, difference = min(a, 1-b).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from voxtpu.grids.voxel_grid import VoxelGrid

OPS = ("void", "union", "intersection", "difference")


@jax.jit
def _union_w(a, b):
    return a | b


@jax.jit
def _intersection_w(a, b):
    return a & b


@jax.jit
def _difference_w(a, b):
    return a & ~b


_WORD_OPS = {
    "union": _union_w,
    "intersection": _intersection_w,
    "difference": _difference_w,
}


_CSG_BACKENDS = ("xla", "reference", "native")


def csg(grid1: VoxelGrid, grid2: VoxelGrid, op: str, backend: str = "xla") -> VoxelGrid:
    """Fold grid2 into grid1 (returns a new grid; shapes must match,
    mirroring the asserts at `csg/naive.cu:30-33`).

    backend: "xla" | "reference" | "native". "xla" is one fused
    memory-bound elementwise op. "reference" runs the same fold in NumPy
    on host (the oracle path, `csg/sequential.cpp:18-28`); "native" in
    C++/OpenMP."""
    if backend not in _CSG_BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r} (expected one of {_CSG_BACKENDS})")
    if op == "void":
        return grid1
    if op not in _WORD_OPS:
        raise ValueError(f"unknown CSG op {op!r}")
    if grid1.words.shape != grid2.words.shape:
        raise ValueError(
            f"CSG grids must have equal shape: {grid1.words.shape} vs {grid2.words.shape}"
        )
    if backend == "native":
        from voxtpu.native import native_csg
        import numpy as np

        words = jnp.asarray(
            native_csg(np.asarray(grid1.words), np.asarray(grid2.words), op)
        )
    elif backend == "reference":
        import numpy as np

        a = np.asarray(grid1.words)
        b = np.asarray(grid2.words)
        host = {"union": a | b, "intersection": a & b,
                "difference": a & ~b}[op]
        words = jnp.asarray(host)
    else:
        words = _WORD_OPS[op](grid1.words, grid2.words)
    return VoxelGrid(words=words, origin=grid1.origin, voxel_size=grid1.voxel_size)


# -- soft (differentiable) ---------------------------------------------------


def soft_union(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.maximum(a, b)


def soft_intersection(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.minimum(a, b)


def soft_difference(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.minimum(a, 1.0 - b)


SOFT_OPS = {
    "union": soft_union,
    "intersection": soft_intersection,
    "difference": soft_difference,
}


def soft_csg(a: jnp.ndarray, b: jnp.ndarray, op: str) -> jnp.ndarray:
    """Differentiable CSG on float occupancy grids in [0, 1]."""
    if op == "void":
        return a
    if op not in SOFT_OPS:
        raise ValueError(f"unknown CSG op {op!r}")
    return SOFT_OPS[op](a, b)
