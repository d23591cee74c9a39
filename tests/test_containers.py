"""Unit tests: mesh container, OBJ I/O, bounding box, packed voxel grid."""

import numpy as np
import pytest

from voxtpu.grids.voxel_grid import GridSpec, VoxelGrid, pack_bits, unpack_bits
from voxtpu.mesh.bounding_box import calculate_bounding_box
from voxtpu.mesh.mesh import Mesh
from voxtpu.mesh.obj_io import export_mesh, import_mesh


def test_import_bunny_counts(bunny_mesh, tmp_path):
    # The stand-in keeps the reference bunny's counts (28088 v, 56172 f)
    # through an OBJ round trip.
    path = tmp_path / "bunny.obj"
    export_mesh(path, bunny_mesh, use_native=False)
    back = import_mesh(path, use_native=False)
    assert back.num_vertices == 28088
    assert back.num_faces == 56172
    assert back.normals.shape[0] == 28088
    back.validate()


def test_import_all_assets(obj_files):
    faces = {"sphere": 1280, "torus": 576, "d20": 20}
    for stem, path in obj_files.items():
        assert import_mesh(path, use_native=False).num_faces == faces[stem]


def test_obj_roundtrip(tmp_path):
    coords = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0.25, 0.25, 1.5]], np.float32
    )
    faces = np.array([[0, 1, 2], [0, 1, 3], [1, 2, 3], [0, 2, 3]], np.int32)
    colors = np.array(
        [[255, 0, 0, 255], [0, 255, 0, 255], [0, 0, 255, 255], [10, 20, 30, 255]],
        np.uint8,
    )
    normals = np.array([[0, 0, 1]] * 4, np.float32)
    mesh = Mesh(
        name="tet", coords=coords, faces=faces, faces_normals=faces,
        colors=colors, normals=normals,
    )
    path = tmp_path / "tet.obj"
    export_mesh(path, mesh, use_native=False)
    back = import_mesh(path, use_native=False)
    np.testing.assert_allclose(back.coords, coords, atol=1e-6)
    np.testing.assert_array_equal(back.faces, faces)
    np.testing.assert_array_equal(back.colors[:, :3], colors[:, :3])


def test_obj_face_formats(tmp_path):
    path = tmp_path / "f.obj"
    path.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\n" "f 1 2 3\n"
    )
    m = import_mesh(path, use_native=False)
    np.testing.assert_array_equal(m.faces, [[0, 1, 2]])

    path.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n")
    m = import_mesh(path, use_native=False)
    np.testing.assert_array_equal(m.faces, [[0, 1, 2]])
    np.testing.assert_array_equal(m.faces_normals, [[0, 0, 0]])


def test_bounding_box():
    pts = np.array([[0, 1, 2], [3, -1, 2], [1, 0, 7]], np.float32)
    side, (mins, maxs) = calculate_bounding_box(pts)
    np.testing.assert_allclose(mins, [0, -1, 2])
    np.testing.assert_allclose(maxs, [3, 1, 7])
    assert side == 5.0


def test_grid_spec_fit(bunny_mesh):
    spec = GridSpec.fit(bunny_mesh.coords, 64)
    assert spec.n == 64
    side, (mins, _) = calculate_bounding_box(bunny_mesh.coords)
    assert spec.voxel_size == pytest.approx(side / 64)
    assert spec.origin == pytest.approx(tuple(mins))


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    occ = rng.random((32, 32, 64)) < 0.3
    words = pack_bits(occ)
    assert words.shape == (32, 32, 2)
    assert words.dtype == np.uint32
    back = np.asarray(unpack_bits(words))
    np.testing.assert_array_equal(back, occ)


def test_voxel_grid_pytree_and_count():
    import jax

    spec = GridSpec(n=32, origin=(0.0, 0.0, 0.0), voxel_size=1.0 / 32)
    rng = np.random.default_rng(1)
    occ = rng.random((32, 32, 32)) < 0.5
    grid = VoxelGrid.from_dense(occ, spec)
    assert int(grid.count()) == int(occ.sum())
    leaves = jax.tree_util.tree_leaves(grid)
    assert len(leaves) == 3
    grid2 = jax.jit(lambda g: g)(grid)
    np.testing.assert_array_equal(np.asarray(grid2.words), np.asarray(grid.words))


def test_grid_requires_multiple_of_32():
    spec = GridSpec(n=33, origin=(0, 0, 0), voxel_size=1.0)
    with pytest.raises(ValueError):
        spec.num_words


def test_obj_ragged_vertex_rows(tmp_path):
    """Mixed colored/uncolored vertex lines and 4-component 'v x y z w'
    must parse (coords kept, colors only when every row has RGB)."""
    from voxtpu.mesh.obj_io import import_mesh

    p = tmp_path / "ragged.obj"
    p.write_text(
        "v 0 0 0\n"
        "v 1 0 0 0.5 0.2 0.1\n"
        "v 0 1 0 0.5\n"          # 4-component weight form, not a color
        "f 1 2 3\n"
    )
    m = import_mesh(p, use_native=False)
    assert m.num_vertices == 3
    assert m.colors.shape[0] == 0  # not all rows carry RGB -> no colors
    assert m.num_faces == 1


def test_obj_mixed_face_forms(tmp_path):
    """Files mixing 'f v v v' and 'f v//vn ...' forms must not scramble
    indices (probe-only detection would misalign the reshape)."""
    from voxtpu.mesh.obj_io import import_mesh

    p = tmp_path / "mixed.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
        "vn 0 0 1\n"
        "f 1//1 2//1 3//1\n"
        "f 2 3 4\n"
    )
    m = import_mesh(p, use_native=False)
    np.testing.assert_array_equal(m.faces, [[0, 1, 2], [1, 2, 3]])
    np.testing.assert_array_equal(m.faces_normals[0], [0, 0, 0])


def test_native_obj_vertex_weight_not_color(tmp_path):
    """'v x y z w' (4th component) must not flag the mesh as colored."""
    pytest.importorskip("ctypes")
    from voxtpu.native import native_import_mesh

    p = tmp_path / "w.obj"
    p.write_text("v 0 0 0 0.5\nv 1 0 0 0.5\nv 0 1 0 0.5\nf 1 2 3\n")
    try:
        m = native_import_mesh(str(p))
    except ImportError:
        pytest.skip("native lib unavailable")
    assert m.num_vertices == 3
    assert m.colors.shape[0] == 0


def test_obj_ngon_raises(tmp_path):
    """Quads/ngons must fail loudly, not silently drop geometry."""
    from voxtpu.mesh.obj_io import import_mesh

    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    with pytest.raises(ValueError, match="triangular"):
        import_mesh(p, use_native=False)


def test_obj_intra_line_mixed_forms(tmp_path):
    """A face line mixing forms INTERNALLY ('f 1/1 2/2/2 3/3/3') must
    parse via the per-token path, not misalign the uniform reshape."""
    from voxtpu.mesh.obj_io import import_mesh

    p = tmp_path / "intra.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "vn 0 0 1\nvn 0 0 1\nvn 0 0 1\n"
        "f 1/1 2/2/2 3/3/3\n"
    )
    m = import_mesh(p, use_native=False)
    np.testing.assert_array_equal(m.faces, [[0, 1, 2]])
    np.testing.assert_array_equal(m.faces_normals, [[0, 1, 2]])


def test_obj_malformed_vertex_row_raises(tmp_path):
    """A vertex row with < 3 components raises a descriptive error."""
    from voxtpu.mesh.obj_io import import_mesh

    p = tmp_path / "short.obj"
    p.write_text("v 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    with pytest.raises(ValueError, match="expected at least 3"):
        import_mesh(p, use_native=False)


def test_obj_junk_color_tokens_kept_as_coords(tmp_path):
    """Rows whose trailing tokens are non-numeric (inline comments) keep
    coordinates and drop the bogus colors instead of crashing."""
    from voxtpu.mesh.obj_io import import_mesh

    p = tmp_path / "junk.obj"
    p.write_text(
        "v 0 0 0 # corner junk junk\n"
        "v 1 0 0 # corner junk junk\n"
        "v 0 1 0 # corner junk junk\n"
        "f 1 2 3\n"
    )
    m = import_mesh(p, use_native=False)
    assert m.num_vertices == 3
    assert m.colors.shape[0] == 0


def test_count_traced_matches_host_count():
    import jax
    import jax.numpy as jnp

    occ = np.zeros((32, 32, 32), bool)
    occ[3:17, 4:20, 5:31] = True
    vg = VoxelGrid.from_dense(jnp.asarray(occ), GridSpec(32, (0, 0, 0), 1.0))
    assert vg.count() == int(occ.sum())
    assert int(jax.jit(lambda g: g.count_traced())(vg)) == int(occ.sum())
