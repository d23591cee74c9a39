"""Native C++/OpenMP backend vs NumPy oracle (skipped if g++ unavailable)."""

import numpy as np
import pytest

pytest.importorskip("voxtpu.native")
try:
    from voxtpu.native import (
        _load,
        native_csg,
        native_export_mesh,
        native_import_mesh,
        native_jfa,
        native_voxelize,
    )

    _load()
except ImportError:
    pytest.skip("native library unavailable", allow_module_level=True)

from voxtpu.grids.voxel_grid import GridSpec
from voxtpu.mesh.obj_io import export_mesh, import_mesh
from voxtpu.ops.reference import csg_ref, jfa_ref, voxelize_ref


def test_native_import_matches_python(bunny_mesh, tmp_path):
    path = str(tmp_path / "bunny.obj")
    export_mesh(path, bunny_mesh, use_native=False)
    py = import_mesh(path, use_native=False)
    nat = native_import_mesh(path)
    np.testing.assert_allclose(nat.coords, py.coords, rtol=1e-6)
    np.testing.assert_array_equal(nat.faces, py.faces)
    np.testing.assert_allclose(nat.normals, py.normals, rtol=1e-6)


def test_native_export_roundtrip(tmp_path, torus_mesh):
    mesh = torus_mesh
    path = str(tmp_path / "t.obj")
    assert native_export_mesh(path, mesh)
    back = import_mesh(path, use_native=False)
    np.testing.assert_allclose(back.coords, mesh.coords, atol=1e-5)
    np.testing.assert_array_equal(back.faces, mesh.faces)


@pytest.mark.parametrize("asset", ["sphere_mesh", "torus_mesh", "d20_mesh"])
def test_native_vox_matches_oracle(asset, request):
    mesh = request.getfixturevalue(asset)
    spec = GridSpec.fit(mesh.coords, 32)
    np.testing.assert_array_equal(native_voxelize(mesh, spec),
                                  voxelize_ref(mesh, spec))


def test_native_jfa_matches_oracle():
    rng = np.random.default_rng(1)
    n = 32
    occ = rng.random((n, n, n)) < 0.15
    spec = GridSpec(n=n, origin=(0.5, -1.0, 0.0), voxel_size=1.0 / n)
    np.testing.assert_allclose(native_jfa(occ, spec), jfa_ref(occ, spec),
                               rtol=1e-6)


@pytest.mark.parametrize("op", ["union", "intersection", "difference"])
def test_native_csg_matches_oracle(op):
    rng = np.random.default_rng(2)
    w1 = rng.integers(0, 2**32, (8, 8, 2), dtype=np.uint32)
    w2 = rng.integers(0, 2**32, (8, 8, 2), dtype=np.uint32)
    got = native_csg(w1, w2, op)
    ref = {"union": w1 | w2, "intersection": w1 & w2,
           "difference": w1 & ~w2}[op]
    np.testing.assert_array_equal(got, ref)


def test_native_rejects_non_triangular_faces(tmp_path):
    """Quads/short faces: the native parser must hand off (rc=-2) so the
    Python spec's ValueError surfaces, never silently truncate (review
    find: half of every quad vanished with g++ present)."""
    from voxtpu.mesh.obj_io import import_mesh

    quad = tmp_path / "quad.obj"
    quad.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    with pytest.raises(ValueError, match="4 vertices"):
        import_mesh(quad)
    short = tmp_path / "short.obj"
    short.write_text("v 0 0 0\nv 1 0 0\nf 1 2\n")
    with pytest.raises(ValueError, match="2 vertices"):
        import_mesh(short)


def test_native_mixed_color_rows_drop_colors(tmp_path):
    """A file mixing plain and colored vertex rows carries no colors on
    EITHER path (the spec's ragged-block rule)."""
    from voxtpu.mesh.obj_io import import_mesh

    p = tmp_path / "mix.obj"
    p.write_text("v 0 0 0 1 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    assert import_mesh(p).colors.shape[0] == 0
    assert import_mesh(p, use_native=False).colors.shape[0] == 0


def test_native_import_validates_indices(tmp_path):
    """Out-of-range face indices raise on the native path too (review
    find: they previously flowed into raw C++ pointer arithmetic)."""
    from voxtpu.mesh.obj_io import import_mesh

    p = tmp_path / "oor.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 9\n")
    with pytest.raises(ValueError, match="out of range"):
        import_mesh(p)
