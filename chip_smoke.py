#!/usr/bin/env python
"""Chip smoke test: the main path once on a GPU, at the reference's
benchmark scale, every result checked.

    python chip_smoke.py              # one card
    python chip_smoke.py --chips 4    # the sharded paths on four cards

One card: a seeded 1,348,128-face bunny stand-in is voxelized at 512^3
(bit-exact against the C++ backend) and 1024^3 (bit-exact against the
sort-based resolve), and a ~20k-face decimation at 128^3 (bit-exact
against the NumPy oracle); the atomic-XOR Triton kernel is timed against
the sort-based resolve; CSG union/difference at 512^3 against the
oracle; JFA at 256^3 against the C++ JFA and at 1024^3 against the
occupancy sign; three VoxelFit Adam steps at 512^3, and the soft
occupancy and vertex gradient at 64^3 against the CPU backend; and the
CLI in this process. With ``--chips 4`` only the multi-card paths run:
sharded JFA, voxelization and fit step against one card, and a 2048^3
wide-encoding sharded JFA.

Every phase prints one line with its time, `peak_bytes_in_use` (the
process's peak so far) and the card's name and power limit. These are
smoke readings, not benchmark numbers. Any failed comparison or
exception exits non-zero; the last line of a passing run is one JSON
object naming the device. There is no CPU fallback: without a GPU the
script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# One process drives the card(s): give it most of the memory.
os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.92")

import numpy as np  # noqa: E402

# JFA distances may differ from the C++ JFA only where the 26-neighbour
# selection meets a near-tie: XLA on the GPU contracts the squared-
# distance sums into FMAs, so a near-tie `<` can pick another seed, and
# the flood carries that choice on. A changed tie rule moved ~0.3% of
# seeds when it was measured on another backend; 1% allows for that
# cascade while a wrong stencil or stride moves most voxels.
JFA_DIFF_SHARE_MAX = 0.01
JFA_RTOL = 1e-5
# GPU vs CPU soft voxelization: float32 sums of up to a few dozen
# sigmoid terms per voxel in another order (atomic scatter-add on the
# GPU) with another exp; the largest occupancy difference read on an
# H100 was 8.8e-5, so 5e-4 absolute; gradients within 1e-3 relative
# plus 1e-3 of their largest magnitude (entries near zero are sums that
# cancel).
SOFT_OCC_ATOL = 5e-4
SOFT_GRAD_RTOL = 1e-3
SOFT_GRAD_ATOL_FRAC = 1e-3


class Report:
    """Prints one line per phase: time, peak memory, the card."""

    def __init__(self, card: str):
        self.card = card

    @contextlib.contextmanager
    def phase(self, name: str):
        from voxtpu.utils.device import peak_bytes

        info: dict = {}
        t0 = time.perf_counter()
        yield info
        dt = time.perf_counter() - t0
        extra = " ".join(f"{k}={v}" for k, v in info.items())
        print(f"phase={name} ok time_s={dt:.3f} "
              f"peak_bytes_in_use={peak_bytes()} card=\"{self.card}\" "
              f"{extra}", flush=True)


def _ms(times) -> str:
    from voxtpu.utils.device import median_ms

    return f"{median_ms(times):.3f}"


# ---------------------------------------------------------------------------
# Phases (sizes are arguments, so CPU tests run them small)
# ---------------------------------------------------------------------------


def phase_mesh(faces: int, seed: int = 0):
    from voxtpu.mesh.generate import bunny

    t0 = time.perf_counter()
    mesh = bunny(faces, seed=seed)
    return mesh, {"faces": mesh.num_faces,
                  "build_s": f"{time.perf_counter() - t0:.3f}"}


def phase_vox(mesh, n: int, check: str, iters: int = 5):
    """voxelize() with a prebuilt plan and with its build, checked
    against `check`: "native" (C++), "oracle" (NumPy) or "device" (the
    sort-based resolve on the same fragments)."""
    import jax

    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.ops.vox import (FragmentPlan, fragments_from_plan,
                                resolve_fragments, uses_atomic_resolve,
                                voxelize)
    from voxtpu.utils.device import timed

    spec = GridSpec.fit(mesh.coords, n)
    t0 = time.perf_counter()
    plan = FragmentPlan(mesh, spec)
    plan_s = time.perf_counter() - t0
    run = lambda: voxelize(mesh, spec, plan=plan).words
    compile_s, times, words = timed(run, iters=iters)
    t0 = time.perf_counter()
    jax.block_until_ready(voxelize(mesh, spec).words)
    with_plan_s = time.perf_counter() - t0
    got = np.asarray(words)
    if check == "native":
        from voxtpu.grids.voxel_grid import pack_bits
        from voxtpu.native import native_voxelize

        want = np.asarray(pack_bits(native_voxelize(mesh, spec)))
    elif check == "oracle":
        from voxtpu.grids.voxel_grid import pack_bits
        from voxtpu.ops.reference import voxelize_ref

        want = np.asarray(pack_bits(voxelize_ref(mesh, spec)))
    elif check == "device":
        cells, xs = fragments_from_plan(plan)
        want = np.asarray(resolve_fragments(cells, xs, n=n))
    else:
        raise ValueError(check)
    diff = int(np.unpackbits((got ^ want).view(np.uint8)).sum())
    assert diff == 0, f"vox {n}^3 differs from {check} in {diff} voxels"
    return words, spec, {
        "n": n, "faces": mesh.num_faces, "check": check, "diff_voxels": 0,
        "resolve": "atomic" if uses_atomic_resolve() else "sort",
        "plan_build_s": f"{plan_s:.3f}", "compile_s": f"{compile_s:.3f}",
        "run_ms": _ms(times), "with_plan_build_ms": f"{with_plan_s * 1e3:.3f}",
        "fragments": plan.num_fragments,
    }


def phase_resolve(mesh, n: int, iters: int = 10):
    """Decision input: the atomic-XOR kernel and the sort-based resolve
    on the same fragments, bit-exact, timed alone and inside the whole
    vox call with a prebuilt plan."""
    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.ops.vox import (FragmentPlan, fragments_from_plan,
                                resolve_fragments)
    from voxtpu.ops.vox_triton import resolve_fragments_atomic
    from voxtpu.utils.device import timed

    spec = GridSpec.fit(mesh.coords, n)
    plan = FragmentPlan(mesh, spec)
    cells, xs = fragments_from_plan(plan)
    paths = {
        "sort": lambda c, x: resolve_fragments(c, x, n=n),
        "atomic": lambda c, x: resolve_fragments_atomic(c, x, n=n),
    }
    info, ref = {"n": n, "fragments": int(cells.shape[0])}, None
    for name, fn in paths.items():
        compile_s, times, out = timed(fn, cells, xs, iters=iters)
        _, e2e, _ = timed(lambda: fn(*fragments_from_plan(plan)), iters=iters)
        out = np.asarray(out)
        if ref is None:
            ref = out
        else:
            assert np.array_equal(out, ref), f"{name} differs from sort"
        info[f"{name}_resolve_ms"] = _ms(times)
        info[f"{name}_vox_ms"] = _ms(e2e)
        info[f"{name}_compile_s"] = f"{compile_s:.3f}"
    return info


def phase_csg(mesh_a, mesh_b, n: int):
    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.ops.csg import csg
    from voxtpu.ops.reference import csg_ref
    from voxtpu.ops.vox import voxelize
    from voxtpu.utils.device import timed

    spec = GridSpec.fit(np.concatenate([mesh_a.coords, mesh_b.coords]), n)
    ga, gb = voxelize(mesh_a, spec), voxelize(mesh_b, spec)
    da, db = np.asarray(ga.to_dense()), np.asarray(gb.to_dense())
    info = {"n": n}
    for op in ("union", "difference"):
        _, times, out = timed(lambda: csg(ga, gb, op).words, iters=5)
        from voxtpu.grids.voxel_grid import unpack_bits

        got = np.asarray(unpack_bits(out))
        assert np.array_equal(got, csg_ref(da, db, op)), f"csg {op} differs"
        info[f"{op}_ms"] = _ms(times)
    return info


def _sdf_check(sdf, occ, want=None):
    """The hard sign must match occupancy exactly; distances may differ
    from `want` only in a bounded share of voxels (near-tie cascades)."""
    sdf = np.asarray(sdf)
    occ = np.asarray(occ, bool)
    bad_sign = int((np.signbit(sdf) != ~occ).sum())
    assert bad_sign == 0, f"JFA sign differs from occupancy in {bad_sign}"
    info = {"sign_mismatch": 0}
    if want is not None:
        both_inf = np.isinf(sdf) & np.isinf(want) & (sdf == want)
        close = np.isclose(sdf, want, rtol=JFA_RTOL, atol=0.0) | both_inf
        share = float((~close).mean())
        assert share <= JFA_DIFF_SHARE_MAX, (
            f"JFA distances differ in {share:.4%} of voxels "
            f"(bound {JFA_DIFF_SHARE_MAX:.2%})")
        info["dist_diff_share"] = f"{share:.6f}"
        info["dist_diff_bound"] = JFA_DIFF_SHARE_MAX
    return info


def phase_jfa(words, spec, check: str):
    """jfa() on a voxelized grid, checked against the C++ JFA
    ("native") or only against the occupancy sign ("sign")."""
    from voxtpu.grids.voxel_grid import VoxelGrid
    from voxtpu.ops.jfa import jfa
    from voxtpu.utils.device import timed

    grid = VoxelGrid(words=words, origin=np.asarray(spec.origin, np.float32),
                     voxel_size=np.float32(spec.voxel_size))
    occ = np.asarray(grid.to_dense())
    compile_s, times, sdf = timed(lambda: jfa(grid, spec), iters=2)
    want = None
    if check == "native":
        from voxtpu.native import native_jfa

        want = native_jfa(occ, spec)
    info = _sdf_check(sdf, occ, want)
    info.update({"n": spec.n, "compile_s": f"{compile_s:.3f}",
                 "run_ms": _ms(times)})
    return info


def phase_fit(mesh, n: int, steps: int = 3, noise_vox: float = 0.5):
    """`steps` VoxelFit Adam steps from perturbed vertices toward the
    hard voxelization of `mesh`: the loss must be finite and fall."""
    import jax
    import jax.numpy as jnp

    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.mesh.mesh import Mesh
    from voxtpu.models.fit import VoxelFit
    from voxtpu.ops.soft_vox import make_soft_plan
    from voxtpu.ops.vox import voxelize

    spec = GridSpec.fit(mesh.coords, n)
    target = voxelize(mesh, spec).to_dense().astype(jnp.float32)
    rng = np.random.default_rng(0)
    noisy = (mesh.coords + rng.normal(0, noise_vox * spec.voxel_size,
                                      mesh.coords.shape)).astype(np.float32)
    t0 = time.perf_counter()
    plan = make_soft_plan(Mesh(name="noisy", coords=noisy, faces=mesh.faces,
                               faces_normals=mesh.faces), spec)
    plan_s = time.perf_counter() - t0
    fit = VoxelFit(plan, target, learning_rate=0.2 * spec.voxel_size)
    state = fit.init(noisy)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = fit.step(state)
        losses.append(float(jax.block_until_ready(metrics["loss"])))
        times.append(time.perf_counter() - t0)
    final = float(fit.loss(state.coords))
    assert np.all(np.isfinite(losses + [final])), losses
    assert final < losses[0], f"fit loss did not fall: {losses} -> {final}"
    return {"n": n, "faces": mesh.num_faces,
            "soft_fragments": plan.num_fragments,
            "plan_build_s": f"{plan_s:.3f}",
            "first_step_s": f"{times[0]:.3f}",
            "step_ms": _ms(times[1:]) if steps > 1 else "n/a",
            "losses": ",".join(f"{v:.6f}" for v in losses + [final])}


def phase_soft_vs_cpu(mesh, n: int):
    """Soft occupancy and vertex gradient on the default device against
    the same function on the CPU backend, at float32 "highest"."""
    import jax
    import jax.numpy as jnp

    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.models.fit import soft_iou_loss
    from voxtpu.ops.soft_vox import make_soft_plan, soft_voxelize
    from voxtpu.ops.vox import voxelize

    spec = GridSpec.fit(mesh.coords, n)
    coords = np.asarray(mesh.coords) * np.float32(1.0001)

    def occ_and_grad():
        # Plan and target are built on the current default device.
        plan = make_soft_plan(mesh, spec)
        target = voxelize(mesh, spec).to_dense().astype(jnp.float32)

        def f(c):
            occ = soft_voxelize(c, plan)
            g = jax.grad(lambda x: soft_iou_loss(soft_voxelize(x, plan),
                                                 target))(c)
            return occ, g

        return jax.jit(f)(jnp.asarray(coords))

    with jax.default_matmul_precision("highest"):
        occ_d, g_d = occ_and_grad()
        with jax.default_device(jax.devices("cpu")[0]):
            occ_c, g_c = occ_and_grad()
    occ_d, g_d = np.asarray(occ_d), np.asarray(g_d)
    occ_c, g_c = np.asarray(occ_c), np.asarray(g_c)
    occ_err = float(np.abs(occ_d - occ_c).max())
    assert occ_err <= SOFT_OCC_ATOL, f"soft occupancy max err {occ_err}"
    gatol = SOFT_GRAD_ATOL_FRAC * float(np.abs(g_c).max())
    np.testing.assert_allclose(g_d, g_c, rtol=SOFT_GRAD_RTOL, atol=gatol)
    return {"n": n, "faces": mesh.num_faces, "occ_max_err": f"{occ_err:.3e}",
            "grad_max_err": f"{float(np.abs(g_d - g_c).max()):.3e}",
            "grad_atol": f"{gatol:.3e}", "grad_rtol": SOFT_GRAD_RTOL}


def phase_cli(mesh_a, mesh_b, n: int, vox_label: str, iters: int = 3):
    """The CLI in this process on two exported meshes: benchmark mode,
    union, SDF. Its profiling lines must name the path that ran."""
    import re

    from voxtpu.cli import main as cli_main
    from voxtpu.mesh.obj_io import export_mesh

    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, m in enumerate((mesh_a, mesh_b)):
            paths.append(os.path.join(tmp, f"mesh{i}.obj"))
            export_mesh(paths[-1], m)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main([*paths, "-n", str(n), "-t", "2", "-p", "1", "-s",
                           "-m", str(iters), "--out-dir", tmp])
    out = buf.getvalue()
    assert rc == 0, f"CLI exited {rc}:\n{out[-2000:]}"
    vox = re.findall(rf"\[{vox_label}\(mesh0\.obj\)\]: ([\d.]+) ms", out)
    assert len(vox) == iters, f"expected {iters} [{vox_label}] lines:\n{out}"
    for label in ("XlaCSG", "XlaJFA"):
        assert re.search(rf"\[{label}\]: [\d.]+ ms", out), f"no [{label}]"
    return {"n": n, "vox_label": vox_label,
            "vox_ms": ",".join(vox)}


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def _zmesh(count: int):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:count]).reshape(1, count),
                ("d", "z"))


def phase_sharded_jfa_wide(n: int, dmesh):
    """A wide-encoding sharded JFA on a ball too large for one card;
    per-card peak memory."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.parallel.sharded_jfa import jfa_sharded
    from voxtpu.utils.device import peak_bytes

    spec = GridSpec(n=n, origin=(0.0, 0.0, 0.0), voxel_size=1.0 / n)
    sharding = NamedSharding(dmesh, P("z", None, None))

    @functools.partial(jax.jit, out_shardings=sharding)
    def ball():
        ii = [jax.lax.broadcasted_iota(jnp.int32, (n, n, n), a) for a in range(3)]
        c = (n - 1) / 2.0
        r2 = sum((i.astype(jnp.float32) - c) ** 2 for i in ii)
        return r2 <= (0.35 * n) ** 2

    occ = ball()
    t0 = time.perf_counter()
    sdf = jax.block_until_ready(jfa_sharded(occ, spec, dmesh, encoding="wide"))
    run_s = time.perf_counter() - t0
    sign_ok = jax.jit(lambda s, o: jnp.sum(jnp.signbit(s) != ~o))(sdf, occ)
    assert int(sign_ok) == 0, f"sign differs in {int(sign_ok)} voxels"
    peaks = [peak_bytes(d) for d in dmesh.devices.ravel()]
    del sdf, occ
    return {"n": n, "encoding": "wide", "run_s_incl_compile": f"{run_s:.3f}",
            "per_card_peak_bytes": ",".join(str(p) for p in peaks)}


def phase_sharded_jfa(mesh, n: int, dmesh):
    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.ops.jfa import jfa
    from voxtpu.ops.vox import voxelize
    from voxtpu.parallel.sharded_jfa import jfa_sharded

    spec = GridSpec.fit(mesh.coords, n)
    occ = voxelize(mesh, spec).to_dense()
    single = np.asarray(jfa(occ, spec))
    t0 = time.perf_counter()
    sharded = np.asarray(jfa_sharded(occ, spec, dmesh))
    run_s = time.perf_counter() - t0
    info = _sdf_check(sharded, np.asarray(occ), single)
    info.update({"n": n, "run_s_incl_compile": f"{run_s:.3f}"})
    return info


def phase_sharded_vox(mesh, n: int, dmesh):
    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.ops.vox import FragmentPlan, voxelize
    from voxtpu.parallel.sharded_vox import voxelize_sharded

    spec = GridSpec.fit(mesh.coords, n)
    plan = FragmentPlan(mesh, spec)
    single = np.asarray(voxelize(mesh, spec, plan=plan).words)
    t0 = time.perf_counter()
    sharded = np.asarray(voxelize_sharded(mesh, spec, dmesh, plan=plan).words)
    run_s = time.perf_counter() - t0
    diff = int(np.unpackbits((sharded ^ single).view(np.uint8)).sum())
    assert diff == 0, f"sharded vox differs in {diff} voxels"
    return {"n": n, "faces": mesh.num_faces, "diff_voxels": 0,
            "run_s_incl_compile": f"{run_s:.3f}"}


def phase_sharded_fit(mesh, n: int, dmesh):
    """One make_sharded_fit step; its loss must equal the unsharded
    soft loss at the same coordinates."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from voxtpu.grids.voxel_grid import GridSpec
    from voxtpu.models.fit import soft_iou_loss
    from voxtpu.ops.soft_vox import make_soft_plan, soft_voxelize
    from voxtpu.ops.vox import voxelize
    from voxtpu.parallel.sharded_fit import make_sharded_fit

    spec = GridSpec.fit(mesh.coords, n)
    target = voxelize(mesh, spec).to_dense().astype(jnp.float32)
    plan = make_soft_plan(mesh, spec)
    coords = jnp.asarray(mesh.coords) * jnp.float32(1.0001)
    with jax.default_matmul_precision("highest"):
        want = float(soft_iou_loss(soft_voxelize(coords, plan), target))
        init_fn, step_fn, _ = make_sharded_fit(plan, dmesh)
        tslab = jax.device_put(target, NamedSharding(dmesh, P("z", None, None)))
        c, opt = init_fn(coords)
        t0 = time.perf_counter()
        c, opt, loss = step_fn(c, opt, tslab)
        loss = float(loss)
    run_s = time.perf_counter() - t0
    assert np.isfinite(loss) and abs(loss - want) <= 1e-5 + 1e-4 * abs(want), (
        f"sharded loss {loss} vs unsharded {want}")
    return {"n": n, "faces": mesh.num_faces, "loss": f"{loss:.6f}",
            "unsharded_loss": f"{want:.6f}",
            "run_s_incl_compile": f"{run_s:.3f}"}


# ---------------------------------------------------------------------------


def run_one_card(rep: Report) -> None:
    from voxtpu.mesh.generate import BENCH_FACES, bunny, decimate_to, torus
    from voxtpu.mesh.mesh import Mesh
    from voxtpu.ops.vox import uses_atomic_resolve

    with rep.phase("mesh") as info:
        mesh, i = phase_mesh(BENCH_FACES)
        info.update(i)
    with rep.phase("vox512_vs_native") as info:
        _, _, i = phase_vox(mesh, 512, "native")
        info.update(i)
    with rep.phase("vox1024_vs_sort_resolve") as info:
        words1024, spec1024, i = phase_vox(mesh, 1024, "device")
        info.update(i)
    with rep.phase("vox128_20k_vs_oracle") as info:
        c, f = decimate_to(mesh.coords, mesh.faces, 20000)
        small = Mesh(name="bunny_20000", coords=c, faces=f, faces_normals=f)
        _, _, i = phase_vox(small, 128, "oracle")
        info.update(i)
    for n in (512, 1024):
        with rep.phase(f"resolve{n}_triton_vs_sort") as info:
            info.update(phase_resolve(mesh, n))
    base = bunny()
    ring = torus(major_radius=0.9, minor_radius=0.3)
    with rep.phase("csg512_vs_oracle") as info:
        info.update(phase_csg(base, ring, 512))
    with rep.phase("jfa256_vs_native") as info:
        words, spec, _ = phase_vox(mesh, 256, "device", iters=1)
        info.update(phase_jfa(words, spec, "native"))
    with rep.phase("jfa512_sign") as info:
        words, spec, _ = phase_vox(mesh, 512, "device", iters=1)
        info.update(phase_jfa(words, spec, "sign"))
    with rep.phase("jfa1024_sign") as info:
        info.update(phase_jfa(words1024, spec1024, "sign"))
    del words1024
    with rep.phase("fit512") as info:
        info.update(phase_fit(mesh, 512))
    with rep.phase("soft64_vs_cpu") as info:
        info.update(phase_soft_vs_cpu(small, 64))
    with rep.phase("cli512") as info:
        label = "TritonVox" if uses_atomic_resolve() else "XlaVox"
        info.update(phase_cli(base, ring, 512, label))


def run_four_cards(rep: Report, count: int) -> None:
    import jax

    from voxtpu.mesh.generate import BENCH_FACES, bunny

    if len(jax.devices()) < count:
        raise SystemExit(f"--chips {count} needs {count} devices, "
                         f"JAX has {len(jax.devices())}")
    dmesh = _zmesh(count)
    # First, while no other phase has touched the cards' peaks.
    with rep.phase("sharded_jfa2048_wide") as info:
        info.update(phase_sharded_jfa_wide(2048, dmesh))
    mesh = bunny(BENCH_FACES)
    with rep.phase("sharded_jfa1024_vs_one_card") as info:
        info.update(phase_sharded_jfa(mesh, 1024, dmesh))
    with rep.phase("sharded_vox1024_vs_one_card") as info:
        info.update(phase_sharded_vox(mesh, 1024, dmesh))
    with rep.phase("sharded_fit256_vs_unsharded") as info:
        info.update(phase_sharded_fit(mesh, 256, dmesh))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    from voxtpu.utils.cache import configure_compile_cache
    from voxtpu.utils.device import (NoGpuError, describe,
                                     nvidia_smi_name_power, require_gpu)

    configure_compile_cache()
    try:
        dev = require_gpu()
    except NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    card = nvidia_smi_name_power()
    print(f"device kind={dev.device_kind} count={describe()['count']} "
          f"nvidia-smi: {card}", flush=True)
    rep = Report(card)
    if args.chips == 4:
        run_four_cards(rep, 4)
    else:
        run_one_card(rep)
    print(json.dumps({"ok": True, "device": describe()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
