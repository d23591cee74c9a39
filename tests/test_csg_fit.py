"""Gradients through CSG compositions (BASELINE north-star config #4)."""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def two_parts(request):
    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.mesh.generate import icosahedron, icosphere
    from voxtpu.models.csg_fit import CSGPart
    from voxtpu.ops.soft_vox import make_soft_plan

    sphere = icosphere(3)
    d20 = icosahedron()
    all_coords = np.concatenate([sphere.coords, d20.coords])
    spec = GridSpec.fit(all_coords, 32)
    parts = [
        CSGPart(plan=make_soft_plan(sphere, spec), op="union"),
        CSGPart(plan=make_soft_plan(d20, spec), op="union"),
    ]
    return (sphere, d20, spec, parts)


def test_compose_matches_hard_union(two_parts):
    import jax.numpy as jnp

    from voxtpu.models.csg_fit import compose
    from voxtpu.ops.csg import csg
    from voxtpu.ops.vox import voxelize

    sphere, d20, spec, parts = two_parts
    soft = compose(
        [jnp.asarray(sphere.coords), jnp.asarray(d20.coords)], parts,
        tau_edge_frac=0.02, tau_x_frac=0.02,
    )
    hard = csg(voxelize(sphere, spec), voxelize(d20, spec), "union")
    hard_occ = np.asarray(hard.to_dense()).astype(np.float32)
    # At low temperature the soft composition approaches the hard union
    # (some voxels near the d20's sharp edges stay blurred — the soft
    # relaxation's intended behavior).
    agree = np.mean((np.asarray(soft) > 0.5) == (hard_occ > 0.5))
    assert agree > 0.95, f"agreement {agree}"


def test_gradients_flow_to_all_parts(two_parts):
    import jax
    import jax.numpy as jnp

    from voxtpu.models.csg_fit import compose

    sphere, d20, spec, parts = two_parts

    def loss(c1, c2):
        occ = compose([c1, c2], parts)
        return jnp.sum(occ**2)

    g1, g2 = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(sphere.coords), jnp.asarray(d20.coords)
    )
    assert np.isfinite(np.asarray(g1)).all()
    assert np.isfinite(np.asarray(g2)).all()
    assert float(jnp.abs(g1).sum()) > 0
    assert float(jnp.abs(g2).sum()) > 0


def test_csg_fit_step_improves(two_parts):
    import jax.numpy as jnp

    from voxtpu.models.csg_fit import CSGFit
    from voxtpu.ops.csg import csg
    from voxtpu.ops.vox import voxelize

    sphere, d20, spec, parts = two_parts
    target = csg(voxelize(sphere, spec), voxelize(d20, spec), "union")
    target_occ = target.to_dense().astype(jnp.float32)

    fit = CSGFit(parts, target_occ, learning_rate=5e-3)
    # Perturb the inputs so there is something to recover.
    rng = np.random.default_rng(0)
    c1 = sphere.coords + rng.normal(0, 0.01, sphere.coords.shape).astype(np.float32)
    c2 = d20.coords + rng.normal(0, 0.01, d20.coords.shape).astype(np.float32)
    coords_list, opt_state = fit.init([c1, c2])
    l0 = float(fit.loss(coords_list))
    for _ in range(5):
        coords_list, opt_state, metrics = fit.step(coords_list, opt_state)
    l1 = float(metrics["loss"])
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < l0, f"loss did not improve: {l0} -> {l1}"


def test_compose_rejects_length_mismatch(two_parts):
    import jax.numpy as jnp
    import pytest

    from voxtpu.models.csg_fit import CSGFit, compose
    from voxtpu.ops.vox import voxelize

    sphere, d20, spec, parts = two_parts
    with pytest.raises(ValueError, match="parts"):
        compose([jnp.asarray(sphere.coords)], parts)
    target = voxelize(sphere, spec).to_dense().astype(jnp.float32)
    fit = CSGFit(parts, target)
    with pytest.raises(ValueError, match="parts"):
        fit.init([sphere.coords])


def test_csg_fit_refreshes_drifted_plans(two_parts):
    """Parts drifting past their pad window must trigger plan rebuilds
    (code-review find: coverage eroded silently with fixed plans)."""
    import jax.numpy as jnp

    from voxtpu.models.csg_fit import CSGFit, CSGPart
    from voxtpu.ops.soft_vox import make_soft_plan
    from voxtpu.ops.vox import voxelize

    sphere, d20, spec, _ = two_parts
    # Fresh parts: refreshes replace part.plan and must not mutate the
    # module-scoped fixture other tests read.
    local = [
        CSGPart(plan=make_soft_plan(sphere, spec), op="union"),
        CSGPart(plan=make_soft_plan(d20, spec), op="union"),
    ]
    target = voxelize(sphere, spec).to_dense().astype(jnp.float32)
    fit = CSGFit(local, target, refresh_every=0)
    coords_list, opt_state = fit.init([sphere.coords, d20.coords])
    # Displace part 0 far beyond the pad window; part 1 stays put.
    moved = [coords_list[0] + 10.0 * spec.voxel_size, coords_list[1]]
    assert fit.maybe_refresh_plans(moved) == 1
    assert fit.refresh_count == 1
    # The refreshed plan's coords now match; no further refresh.
    assert fit.maybe_refresh_plans(moved) == 0
