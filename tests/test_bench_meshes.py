"""Generated meshes (voxtpu.mesh.generate): counts, closedness, seeds,
and exact-count subdivision and decimation along the reference's
bunny ladder (`benchmarks_v2/bunny_3510 ... bunny_10785024`)."""

import numpy as np
import pytest

from voxtpu.mesh import generate as gen


@pytest.mark.parametrize("name,faces,verts", [
    ("icosahedron", 20, 12), ("icosphere", 1280, 642), ("torus", 576, 288),
    ("bunny", 56172, 28088)])
def test_generator_counts_and_closed(name, faces, verts):
    mesh = getattr(gen, name)()
    assert mesh.num_faces == faces
    assert mesh.num_vertices == verts
    assert gen.is_closed(mesh.faces)
    assert gen.signed_volume(mesh.coords, mesh.faces) > 0  # outward
    mesh.validate()


def test_bunny_is_seeded():
    a, b, c = gen.bunny(seed=0), gen.bunny(seed=0), gen.bunny(seed=1)
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert not np.array_equal(a.coords, c.coords)


def test_bunny_standin_features(bunny_mesh):
    """What the voxelizers are sensitive to: concavity, many crossings
    per X column, a wide spread of triangle sizes, x-parallel faces."""
    tri = bunny_mesh.coords.astype(np.float64)[bunny_mesh.faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 1])
    area = np.linalg.norm(n, axis=1) / 2
    assert area.max() / area.min() > 1e3
    assert (n[:, 0] == 0).sum() > 0                     # exactly parallel
    tilt = np.abs(n[:, 0]) / np.linalg.norm(n, axis=1)
    assert ((tilt > 0) & (tilt < 1e-3)).sum() > 0       # nearly parallel
    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.ops.reference import voxelize_ref

    spec = GridSpec.fit(bunny_mesh.coords, 32)
    occ = voxelize_ref(bunny_mesh, spec)
    runs = (np.diff(occ.astype(np.int8), axis=2) == 1).sum(axis=2)
    assert runs.max() >= 2  # some X column enters the solid twice
    hull_vol = np.prod(np.ptp(bunny_mesh.coords, axis=0))
    assert gen.signed_volume(bunny_mesh.coords, bunny_mesh.faces) < 0.6 * hull_vol


def test_subdivide_to_exact_counts(bunny_mesh):
    for t in (56172, 168516, 224688):
        c, f = gen.subdivide_to(bunny_mesh.coords, bunny_mesh.faces, t)
        assert f.shape[0] == t
        assert f.min() >= 0 and f.max() < c.shape[0]
    assert gen.bunny(gen.BENCH_FACES).num_faces == 1348128


def test_decimate_to_exact_counts(bunny_mesh):
    for t in (3510, 28086):
        c, f = gen.decimate_to(bunny_mesh.coords, bunny_mesh.faces, t)
        assert f.shape[0] == t
        assert f.min() >= 0 and f.max() < c.shape[0]
        # No degenerate (repeated-index) faces.
        assert (f[:, 0] != f[:, 1]).all()
        assert (f[:, 1] != f[:, 2]).all()
        assert (f[:, 0] != f[:, 2]).all()
        # The coarse proxy keeps the bunny's extent (same bbox scale).
        ptp0 = np.ptp(bunny_mesh.coords, axis=0)
        ptp1 = np.ptp(c, axis=0)
        assert np.all(ptp1 > 0.7 * ptp0) and np.all(ptp1 <= 1.05 * ptp0)


def test_decimate_to_rejects_upscale(bunny_mesh):
    with pytest.raises(ValueError, match=">= current"):
        gen.decimate_to(bunny_mesh.coords, bunny_mesh.faces, 10**7)
