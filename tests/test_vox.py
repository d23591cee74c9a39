"""Voxelization: XLA backend vs NumPy oracle, plus geometric invariants."""

import numpy as np
import pytest

from voxtpu.grids.voxel_grid import GridSpec
from voxtpu.ops.reference import voxelize_ref
from voxtpu.ops.vox import voxelize


def _dense(mesh, n, backend):
    spec = GridSpec.fit(mesh.coords, n)
    grid = voxelize(mesh, spec, backend=backend)
    return np.asarray(grid.to_dense()), spec


@pytest.mark.parametrize("n", [32, 64])
def test_xla_matches_oracle_sphere(sphere_mesh, n):
    spec = GridSpec.fit(sphere_mesh.coords, n)
    ref = voxelize_ref(sphere_mesh, spec)
    got = np.asarray(voxelize(sphere_mesh, spec, backend="xla").to_dense())
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mesh_name", ["torus_mesh", "d20_mesh"])
def test_xla_matches_oracle_assets(mesh_name, request):
    mesh = request.getfixturevalue(mesh_name)
    spec = GridSpec.fit(mesh.coords, 32)
    ref = voxelize_ref(mesh, spec)
    got = np.asarray(voxelize(mesh, spec, backend="xla").to_dense())
    np.testing.assert_array_equal(got, ref)


def test_xla_matches_oracle_bunny64(bunny_mesh):
    spec = GridSpec.fit(bunny_mesh.coords, 64)
    ref = voxelize_ref(bunny_mesh, spec)
    got = np.asarray(voxelize(bunny_mesh, spec, backend="xla").to_dense())
    np.testing.assert_array_equal(got, ref)


def test_sphere_solid_and_contiguous(sphere_mesh):
    """Solid fill invariant: every X column of a voxelized sphere is one
    contiguous run, and the volume approximates (4/3) pi r^3."""
    occ, spec = _dense(sphere_mesh, 64, "xla")
    n = spec.n
    runs_ok = True
    for z in range(n):
        cols = occ[z]  # (y, x)
        d = np.diff(cols.astype(np.int8), axis=1)
        # one contiguous run <=> at most one +1 and one -1 transition
        rises = (d == 1).sum(axis=1)
        falls = (d == -1).sum(axis=1)
        if (rises > 1).any() or (falls > 1).any():
            runs_ok = False
    assert runs_ok

    vol_vox = occ.sum() * spec.voxel_size**3
    side, (mins, maxs) = (
        (maxs_mins := None),
        (None, None),
    ) if False else (None, (None, None))
    ext = sphere_mesh.coords.max(0) - sphere_mesh.coords.min(0)
    r = float(ext[0]) / 2
    vol_true = 4 / 3 * np.pi * r**3
    assert abs(vol_vox - vol_true) / vol_true < 0.1


def test_empty_mesh():
    from voxtpu.mesh.mesh import Mesh

    mesh = Mesh(name="empty")
    spec = GridSpec(n=32, origin=(0, 0, 0), voxel_size=1 / 32)
    occ = np.asarray(voxelize(mesh, spec, backend="xla").to_dense())
    assert occ.sum() == 0


def test_translated_grid_origin(sphere_mesh):
    """Voxelization must honor a non-zero world origin."""
    mesh = sphere_mesh
    spec = GridSpec.fit(mesh.coords, 32)
    ref = voxelize_ref(mesh, spec)
    # Shift both mesh and origin: identical occupancy.
    from voxtpu.mesh.mesh import Mesh

    shifted = Mesh(
        name="s",
        coords=mesh.coords + np.float32(3.5),
        normals=mesh.normals,
        colors=mesh.colors,
        faces=mesh.faces,
        faces_normals=mesh.faces_normals,
    )
    spec2 = GridSpec(
        n=32,
        origin=tuple(np.float32(o) + np.float32(3.5) for o in spec.origin),
        voxel_size=spec.voxel_size,
    )
    got = np.asarray(voxelize(shifted, spec2, backend="xla").to_dense())
    # Allow tiny deviations from float re-rounding of shifted coordinates.
    assert (got ^ ref).sum() <= got.sum() * 0.01


def test_voxelize_rejects_unpacked_n(sphere_mesh):
    """Packed grids need N % 32 == 0; n=48 used to silently build a
    1-word grid that truncated columns 32..47."""
    import pytest

    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.ops.vox import voxelize

    spec = GridSpec.fit(sphere_mesh.coords, 48)
    with pytest.raises(ValueError, match="N % 32"):
        voxelize(sphere_mesh, spec, backend="xla")


def _xor_fill_numpy(cells, xs, n):
    """Apply the atomic kernel's per-fragment terms with NumPy's
    unbuffered XOR scatter — the kernel's arithmetic, minus the card."""
    from voxtpu.ops.vox_triton import fragment_terms

    nw = n // 32
    valid, word, mask, later = (np.asarray(a) for a in fragment_terms(
        jnp.asarray(cells), jnp.asarray(xs), n=n))
    words = np.zeros(n * n * nw, np.int32)
    np.bitwise_xor.at(words, word[valid], mask[valid])
    flags = np.zeros(n * n * nw, np.int32)
    sel = valid & (later > 0)
    np.bitwise_xor.at(flags, word[sel] + 1, np.int32(1))
    flip = np.cumsum(flags.reshape(-1, nw), axis=1) & 1
    words ^= (-flip).astype(np.int32).reshape(-1)
    return words.view(np.uint32).reshape(n, n, nw)


import jax.numpy as jnp  # noqa: E402


@pytest.mark.parametrize("mesh_name,n", [("torus_mesh", 64),
                                         ("bunny_mesh", 96),
                                         ("sphere_mesh", 32),
                                         ("d20_mesh", 128),
                                         ("bunny_mesh", 256)])
def test_atomic_terms_match_sort_resolve(mesh_name, n, request):
    """The atomic kernel's index and mask math (fragment_terms), applied
    by XOR scatter, equals the sort-based resolve_fragments."""
    from voxtpu.ops.vox import (FragmentPlan, fragments_from_plan,
                                resolve_fragments)

    mesh = request.getfixturevalue(mesh_name)
    spec = GridSpec.fit(mesh.coords, n)
    cells, xs = fragments_from_plan(FragmentPlan(mesh, spec))
    want = np.asarray(resolve_fragments(cells, xs, n=n))
    got = _xor_fill_numpy(np.asarray(cells), np.asarray(xs), n)
    np.testing.assert_array_equal(got, want)


def test_fragment_terms_masks_and_carries():
    """Own-word mask ``0xFFFFFFFF << b``, flat word index, later-word
    count and the sentinel's invalidity, for hand-picked fragments."""
    from voxtpu.ops.vox_triton import fragment_terms

    n = 64  # two words per column
    cells = jnp.asarray([0, 5, 5, n * n], jnp.int32)
    xs = jnp.asarray([0, 31, 33, 0], jnp.int32)
    valid, word, mask, later = (np.asarray(a) for a in
                                fragment_terms(cells, xs, n=n))
    assert valid.tolist() == [True, True, True, False]
    assert word[:3].tolist() == [0, 10, 11]
    assert mask[:3].view(np.uint32).tolist() == [0xFFFFFFFF, 0x80000000,
                                                 0xFFFFFFFE]
    assert later[:3].tolist() == [1, 1, 0]


def test_resolve_picks_sort_path_off_gpu(sphere_mesh):
    from voxtpu.ops import vox

    assert not vox.uses_atomic_resolve()
    spec = GridSpec.fit(sphere_mesh.coords, 32)
    cells, xs = vox.fragments_from_plan(vox.FragmentPlan(sphere_mesh, spec))
    np.testing.assert_array_equal(
        np.asarray(vox.resolve(cells, xs, n=32)),
        np.asarray(vox.resolve_fragments(cells, xs, n=32)))


def test_atomic_resolve_rejects_huge_n():
    from voxtpu.ops.vox_triton import resolve_fragments_atomic

    z = jnp.zeros((8,), jnp.int32)
    with pytest.raises(ValueError, match="4096"):
        resolve_fragments_atomic(z, z, n=8192)


def test_atomic_kernel_lowers_for_cuda():
    """The Triton kernel lowers to a CUDA module here, without a card
    (the GPU compiler itself runs only on the card)."""
    import jax

    from voxtpu.ops.vox_triton import resolve_fragments_atomic

    c = jax.ShapeDtypeStruct((5000,), jnp.int32)
    text = resolve_fragments_atomic.trace(c, c, n=64).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "vox_resolve_atomic" in text


def test_pad_granular_bounds():
    from voxtpu.ops.vox import _next_pow2, _pad_granular

    for c in (1, 7, 255, 256, 257, 1000, 5000, 1 << 20, (1 << 20) + 1):
        p = _pad_granular(c)
        assert p >= c
        # waste < one granule = next_pow2(c)/8 (<= 25% of c, typ. 12.5%)
        assert p - c < max(256, _next_pow2(c) // 8)


def test_fragment_plan_counts(bunny_mesh):
    """Every triangle lands in exactly one bucket, rows are padded at
    1/8-octave granularity, and num_fragments counts W^2 candidates."""
    from voxtpu.ops.vox import FragmentPlan, _pad_granular

    spec = GridSpec.fit(bunny_mesh.coords, 64)
    plan = FragmentPlan(bunny_mesh, spec)
    rows = [b[1].shape[0] for b in plan.buckets]
    real = sum(int((np.asarray(b[4]) < spec.n).sum()) for b in plan.buckets)
    assert real == bunny_mesh.num_faces
    assert all(r == _pad_granular(r) for r in rows)
    assert plan.num_fragments == sum(
        r * min(b[0], spec.n) ** 2 for r, b in zip(rows, plan.buckets))


@pytest.mark.gpu
def test_atomic_kernel_matches_sort_resolve_on_gpu(gpu_device, bunny_mesh):
    from voxtpu.ops.vox import (FragmentPlan, fragments_from_plan,
                                resolve_fragments)
    from voxtpu.ops.vox_triton import resolve_fragments_atomic

    spec = GridSpec.fit(bunny_mesh.coords, 128)
    cells, xs = fragments_from_plan(FragmentPlan(bunny_mesh, spec))
    np.testing.assert_array_equal(
        np.asarray(resolve_fragments_atomic(cells, xs, n=128)),
        np.asarray(resolve_fragments(cells, xs, n=128)))
