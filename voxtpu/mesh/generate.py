"""Seeded test and benchmark meshes.

Every mesh the tests, examples and benchmarks use is generated here, so
the repository needs no asset files:

- :func:`icosahedron` — the 20-face d20;
- :func:`icosphere` — subdivision 3 gives the 1,280-face sphere;
- :func:`torus` — 576 faces by default;
- :func:`bunny` — a seeded, closed, non-convex stand-in for the Stanford
  bunny with the reference's vertex and face counts (28,088 / 56,172),
  carried to any face count by :func:`subdivide_to` and
  :func:`decimate_to` (the reference's benchmark ladder runs from 3,510
  to 10,785,024 faces; its headline mesh has 1,348,128).

The stand-in keeps what the voxelizers are sensitive to: concavities,
X columns that cross the surface many times, triangle sizes from slivers
at a pole to large cap triangles at the other, and a band of faces that
are exactly or nearly parallel to the X axis (the knife edges of the
entry-point division, ``D / A`` with ``A ~ 0``).

All meshes are closed, with outward (counter-clockwise seen from
outside) winding, which the soft voxelizer's winding sum relies on.
"""

from __future__ import annotations

import numpy as np

from voxtpu.mesh.mesh import Mesh

BUNNY_FACES = 56172       # the reference's bunny.obj (28,088 vertices)
BENCH_FACES = 1348128     # BASELINE.md's benchmark mesh


def _mesh(name: str, coords, faces) -> Mesh:
    """Mesh with area-weighted per-vertex normals (faces_normals = faces)."""
    coords = np.asarray(coords, np.float32)
    faces = np.asarray(faces, np.int32)
    tri = coords.astype(np.float64)[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros((len(coords), 3))
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-30)
    return Mesh(name=name, coords=coords, normals=vn.astype(np.float32),
                faces=faces, faces_normals=faces.copy())


def signed_volume(coords: np.ndarray, faces: np.ndarray) -> float:
    """Enclosed volume by the divergence theorem (> 0 for outward winding)."""
    tri = np.asarray(coords, np.float64)[faces]
    return float(np.einsum("ij,ij->i", tri[:, 0],
                           np.cross(tri[:, 1], tri[:, 2])).sum() / 6.0)


def is_closed(faces: np.ndarray) -> bool:
    """Every directed edge appears once and its reverse once: a closed,
    consistently oriented 2-manifold (by index)."""
    f = np.asarray(faces, np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    nv = int(f.max()) + 1 if f.size else 0
    key = e[:, 0] * nv + e[:, 1]
    rev = e[:, 1] * nv + e[:, 0]
    if np.unique(key).size != key.size:
        return False
    return bool(np.isin(rev, key).all())


def _orient_outward(coords, faces):
    if signed_volume(coords, faces) < 0:
        faces = faces[:, ::-1].copy()
    return faces


# ---------------------------------------------------------------------------
# Platonic / analytic shapes
# ---------------------------------------------------------------------------


def icosahedron(radius: float = 1.0) -> Mesh:
    """Regular icosahedron (12 vertices, 20 faces)."""
    p = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([
        (-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0),
        (0, -1, p), (0, 1, p), (0, -1, -p), (0, 1, -p),
        (p, 0, -1), (p, 0, 1), (-p, 0, -1), (-p, 0, 1),
    ], np.float64)
    v *= radius / np.linalg.norm(v[0])
    f = np.array([
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ], np.int32)
    return _mesh("d20", v, _orient_outward(v, f))


def icosphere(subdivisions: int = 3, radius: float = 1.0) -> Mesh:
    """Geodesic sphere: the icosahedron with each face split 1:4
    `subdivisions` times, midpoints shared and pushed to the sphere
    (20 * 4**s faces; s = 3 gives 1,280)."""
    base = icosahedron(1.0)
    v = base.coords.astype(np.float64)
    f = base.faces.astype(np.int64)
    for _ in range(subdivisions):
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        e.sort(axis=1)
        uniq, inv = np.unique(e[:, 0] * len(v) + e[:, 1], return_inverse=True)
        a, b = uniq // len(v), uniq % len(v)
        mid = v[a] + v[b]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = len(v) + inv.reshape(3, -1)  # (3, F): midpoints of ab, bc, ca
        v = np.concatenate([v, mid])
        f = np.concatenate([
            np.stack([f[:, 0], m[0], m[2]], 1),
            np.stack([m[0], f[:, 1], m[1]], 1),
            np.stack([m[2], m[1], f[:, 2]], 1),
            np.stack([m[0], m[1], m[2]], 1),
        ])
    return _mesh("sphere", v * radius, f)


def torus(major_segments: int = 24, minor_segments: int = 12,
          major_radius: float = 1.0, minor_radius: float = 0.35) -> Mesh:
    """Ring torus around the Z axis (2 * major * minor faces; 576 by
    default). Its hole gives X columns four surface crossings."""
    i = np.arange(major_segments)
    j = np.arange(minor_segments)
    u = 2 * np.pi * i / major_segments
    w = 2 * np.pi * j / minor_segments
    ring = major_radius + minor_radius * np.cos(w)[None, :]
    x = ring * np.cos(u)[:, None]
    y = ring * np.sin(u)[:, None]
    z = np.broadcast_to(minor_radius * np.sin(w)[None, :], x.shape)
    v = np.stack([x, y, z], -1).reshape(-1, 3)
    idx = lambda a, b: (a % major_segments) * minor_segments + b % minor_segments
    ii, jj = np.meshgrid(i, j, indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    q00, q10 = idx(ii, jj), idx(ii + 1, jj)
    q01, q11 = idx(ii, jj + 1), idx(ii + 1, jj + 1)
    f = np.concatenate([np.stack([q00, q10, q11], 1),
                        np.stack([q00, q11, q01], 1)])
    return _mesh("torus", v, _orient_outward(v, f))


# ---------------------------------------------------------------------------
# Bunny stand-in
# ---------------------------------------------------------------------------


def bunny(faces: int = BUNNY_FACES, seed: int = 0) -> Mesh:
    """Seeded non-convex stand-in for the Stanford bunny at exactly
    `faces` faces (above the base count by :func:`subdivide_to`, below it
    by :func:`decimate_to`).

    The base surface is a tube along X closed by two pole fans: 151 rings
    of 186 vertices, each ring in a plane x = const (so the surface is
    embedded whatever the radii), for 28,088 vertices and 56,172 faces.
    Ring radii carry seeded bumps of both signs (concavities and two
    narrow "ears") and a ripple along X (columns with many crossings);
    rings crowd toward one pole (sliver triangles) and thin out toward
    the other (large cap triangles); and a band of rings repeats one
    radius profile, with a relative creep of up to 3e-6, so its quads
    are exactly or nearly parallel to X.
    """
    rng = np.random.default_rng(seed)
    n_rings, n_seg = 151, 186
    s = np.arange(1, n_rings + 1) / (n_rings + 1)
    theta = np.pi * s ** 1.5                        # dense near theta = 0
    phi = 2 * np.pi * np.arange(n_seg) / n_seg
    th, ph = np.meshgrid(theta, phi, indexing="ij")  # (rings, seg)
    dirs = np.stack([-np.cos(th), np.sin(th) * np.cos(ph),
                     np.sin(th) * np.sin(ph)], -1)

    def bump(center, amp, width):
        c = np.asarray(center, np.float64)
        c = c / np.linalg.norm(c)
        ang = np.arccos(np.clip(dirs @ c, -1.0, 1.0))
        return amp * np.exp(-(ang / width) ** 2)

    radius = np.ones_like(th)
    for _ in range(10):
        radius += bump(rng.normal(size=3), rng.uniform(-0.35, 0.5),
                       rng.uniform(0.15, 0.6))
    for side in (-1.0, 1.0):  # ears
        radius += bump((0.5 + rng.uniform(-0.1, 0.1), 0.6,
                        side * (0.35 + rng.uniform(-0.1, 0.1))), 0.9, 0.12)
    radius *= 1.0 + 0.15 * np.sin(7.0 * th + rng.uniform(0, 2 * np.pi))
    radius = np.maximum(radius, 0.2)
    rho = radius * np.sin(th)
    step = 1e-3 * np.arange(n_rings)  # rings strictly increase in x
    x = np.maximum.accumulate(-radius.mean(axis=1) * np.cos(theta) - step)
    x += step
    # Band of rings parallel to X: one profile, then a relative creep.
    band = slice(n_rings // 2, n_rings // 2 + 4)
    rho[band] = rho[band.start] * (1.0 + np.array([0, 0, 1e-6, 3e-6]))[:, None]

    ring_v = np.stack([np.broadcast_to(x[:, None], rho.shape),
                       rho * np.cos(ph), rho * np.sin(ph)], -1)
    poles = np.array([[x[0] - 0.02, 0.0, 0.0], [x[-1] + 0.3, 0.0, 0.0]])
    v = np.concatenate([ring_v.reshape(-1, 3), poles])
    v *= np.array([1.0, 0.85, 0.95])
    lo_pole, hi_pole = n_rings * n_seg, n_rings * n_seg + 1
    k = np.arange(n_seg)
    k1 = (k + 1) % n_seg
    r = np.arange(n_rings - 1)[:, None]
    a, b = r * n_seg + k, r * n_seg + k1
    c, d = a + n_seg, b + n_seg
    last = (n_rings - 1) * n_seg
    f = np.concatenate([
        np.stack([np.full(n_seg, lo_pole), k1, k], 1),
        np.stack([a.ravel(), b.ravel(), d.ravel()], 1),
        np.stack([a.ravel(), d.ravel(), c.ravel()], 1),
        np.stack([np.full(n_seg, hi_pole), last + k, last + k1], 1),
    ])
    base = _mesh("bunny", v, _orient_outward(v, f))
    if faces == base.num_faces:
        return base
    fn = subdivide_to if faces > base.num_faces else decimate_to
    coords, tris = fn(base.coords, base.faces, faces)
    return _mesh(f"bunny_{faces}", coords, tris)


GENERATED = {"d20": icosahedron, "sphere": icosphere, "torus": torus,
             "bunny": bunny}


def mesh_by_name(name_or_path: str) -> Mesh:
    """A generated mesh by name (d20, sphere, torus, bunny), or else an
    OBJ file read from the given path."""
    if name_or_path in GENERATED:
        return GENERATED[name_or_path]()
    from voxtpu.mesh.obj_io import import_mesh

    return import_mesh(name_or_path)


# ---------------------------------------------------------------------------
# Exact face-count control
# ---------------------------------------------------------------------------


def subdivide(coords: np.ndarray, faces: np.ndarray, times: int):
    """Midpoint 1:4 subdivision (midpoints are per face, not shared; they
    coincide bit for bit because (a + b) / 2 is symmetric)."""
    for _ in range(times):
        v0 = coords[faces[:, 0]]
        v1 = coords[faces[:, 1]]
        v2 = coords[faces[:, 2]]
        base = coords.shape[0]
        f = faces.shape[0]
        coords = np.concatenate(
            [coords, (v0 + v1) / 2, (v1 + v2) / 2, (v2 + v0) / 2]
        ).astype(np.float32)
        i01 = base + np.arange(f)
        i12 = base + f + np.arange(f)
        i20 = base + 2 * f + np.arange(f)
        faces = np.concatenate([
            np.stack([faces[:, 0], i01, i20], 1),
            np.stack([i01, faces[:, 1], i12], 1),
            np.stack([i20, i12, faces[:, 2]], 1),
            np.stack([i01, i12, i20], 1),
        ]).astype(np.int32)
    return coords, faces


def subdivide_to(coords: np.ndarray, faces: np.ndarray, target: int):
    """Exact face-count control: full 1:4 subdivisions while they fit,
    then longest-edge bisection of the first (target - F) triangles.
    56,172 faces -> 1,348,128 is BASELINE.md's benchmark mesh
    (2 subdivisions + 449,376 splits)."""
    while faces.shape[0] * 4 <= target:
        coords, faces = subdivide(coords, faces, 1)
    extra = target - faces.shape[0]
    if extra < 0:
        raise ValueError(f"target {target} < current {faces.shape[0]}")
    if extra == 0:
        return coords, faces
    nf = faces.shape[0]
    if extra > 2 * nf:
        raise ValueError(f"cannot reach {target} from {nf} in one pass")
    if extra > nf:
        # Centroid-trisect the first (extra - nf) triangles (+2 faces
        # each), bisect the rest of the gap (10,785,024 = 3 x the
        # 3,595,008-face subdivision: all trisected).
        s = extra - nf
        cen = coords[faces[:s]].mean(axis=1).astype(np.float32)
        m = coords.shape[0] + np.arange(s)
        coords = np.concatenate([coords, cen]).astype(np.float32)
        a, b, c = faces[:s, 0], faces[:s, 1], faces[:s, 2]
        faces = np.concatenate([
            np.stack([a, b, m], 1),
            np.stack([b, c, m], 1),
            np.stack([c, a, m], 1),
            faces[s:],
        ]).astype(np.int32)
        extra = target - faces.shape[0]
        if extra == 0:
            return coords, faces
    tri = coords[faces[:extra]]  # (E, 3, 3)
    e = np.stack([
        ((tri[:, 0] - tri[:, 1]) ** 2).sum(1),
        ((tri[:, 1] - tri[:, 2]) ** 2).sum(1),
        ((tri[:, 2] - tri[:, 0]) ** 2).sum(1),
    ], 1)
    longest = e.argmax(1)  # edge (i, i+1 mod 3)
    rows = np.arange(extra)
    a = faces[rows, longest]
    b = faces[rows, (longest + 1) % 3]
    c = faces[rows, (longest + 2) % 3]
    mid = (coords[a] + coords[b]) / 2
    m = coords.shape[0] + rows
    coords = np.concatenate([coords, mid]).astype(np.float32)
    faces = np.concatenate([np.stack([a, m, c], 1), np.stack([m, b, c], 1),
                            faces[extra:]]).astype(np.int32)
    assert faces.shape[0] == target
    return coords, faces


def decimate_to(coords: np.ndarray, faces: np.ndarray, target: int):
    """Reduce to EXACTLY `target` faces: vertex-clustering collapse to
    just under the target, then :func:`subdivide_to` back up. The
    geometry is a coarse proxy of the input (the reference decimated its
    benchmark bunnies offline); voxelization cost tracks face and
    fragment counts, not fine shape."""
    if target >= faces.shape[0]:
        raise ValueError(f"target {target} >= current {faces.shape[0]}")

    def cluster(res: int):
        lo = coords.min(axis=0)
        span = max(float(np.ptp(coords, axis=0).max()), 1e-9)
        cell = np.clip(((coords - lo) / span * res).astype(np.int64),
                       0, res - 1)
        key = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
        uniq, inv = np.unique(key, return_inverse=True)
        sums = np.zeros((uniq.size, 3), np.float64)
        np.add.at(sums, inv, coords)
        cnt = np.bincount(inv, minlength=uniq.size)[:, None]
        f = inv[faces]
        keep = ((f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2])
                & (f[:, 0] != f[:, 2]))
        return (sums / cnt).astype(np.float32), f[keep].astype(np.int32)

    # Binary-search the clustering resolution for the largest face count
    # still <= target (so subdivision can top it up exactly).
    lo_r, hi_r = 2, 2048
    best = None
    while lo_r <= hi_r:
        mid = (lo_r + hi_r) // 2
        c, f = cluster(mid)
        if f.shape[0] <= target:
            best = (c, f)
            lo_r = mid + 1
        else:
            hi_r = mid - 1
    if best is None or best[1].shape[0] == 0:
        raise ValueError(f"cannot decimate to {target} faces")
    c, f = best
    if target - f.shape[0] > 2 * f.shape[0]:
        raise ValueError(
            f"decimation landed too far below target ({f.shape[0]} vs "
            f"{target}); raise the resolution search range")
    return subdivide_to(c, f, target)
