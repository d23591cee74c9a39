"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device testing without several accelerators is idiomatic JAX
(SURVEY.md §4): force the host platform and fake 8 devices so
sharding/collective paths compile and execute. Must run before the first
`import jax`. Tests that need a GPU take the `gpu_device` fixture and
carry the `gpu` marker; they skip here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_collection_modifyitems(session, config, items):
    """Start the 2-process distributed workers at collection time and
    move their test to the end of the run: the ~4 min the worker pair
    needs then overlaps the rest of the suite instead of serializing
    with it (the test itself just joins and asserts)."""
    dist = [it for it in items
            if it.name == "test_two_process_mesh_jfa"]
    if dist and len(items) > len(dist) and not config.option.collectonly:
        from tests.test_distributed import launch_workers

        config._voxtpu_dist_workers = launch_workers()
        for it in dist:
            items.remove(it)
            items.append(it)


def pytest_unconfigure(config):
    # If the run aborted before the distributed test joined (e.g. -x
    # stop), don't leave the worker pair orphaned.
    for p in getattr(config, "_voxtpu_dist_workers", ()):
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="session")
def sphere_mesh():
    from voxtpu.mesh.generate import icosphere

    return icosphere(3)


@pytest.fixture(scope="session")
def torus_mesh():
    from voxtpu.mesh.generate import torus

    return torus()


@pytest.fixture(scope="session")
def d20_mesh():
    from voxtpu.mesh.generate import icosahedron

    return icosahedron()


@pytest.fixture(scope="session")
def bunny_mesh():
    from voxtpu.mesh.generate import bunny

    return bunny()


@pytest.fixture
def obj_files(tmp_path, sphere_mesh, torus_mesh, d20_mesh):
    """The generated meshes written as sphere.obj / torus.obj / d20.obj
    under the test's tmp_path; returns {stem: path}."""
    from voxtpu.mesh.obj_io import export_mesh

    out = {}
    for name, mesh in (("sphere", sphere_mesh), ("torus", torus_mesh),
                       ("d20", d20_mesh)):
        out[name] = str(tmp_path / f"{name}.obj")
        export_mesh(out[name], mesh)
    return out


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a CUDA GPU (run on the card)")
    return dev


def random_soup_mesh(num_faces: int, seed: int = 0):
    """Random closed-ish triangle fan around a point — only used where the
    test doesn't require a watertight surface."""
    from voxtpu.mesh.mesh import Mesh

    rng = np.random.default_rng(seed)
    coords = rng.uniform(0.05, 0.95, size=(num_faces * 3, 3)).astype(np.float32)
    faces = np.arange(num_faces * 3, dtype=np.int32).reshape(-1, 3)
    return Mesh(name="soup", coords=coords, faces=faces, faces_normals=faces)
