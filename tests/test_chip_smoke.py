"""chip_smoke.py's phases at tiny sizes on the CPU (the chip run uses
the same functions at full size), and its refusal to run without a GPU."""

import json

import numpy as np
import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def small_bunny():
    mesh, info = cs.phase_mesh(3000)
    assert info["faces"] == 3000
    return mesh


@pytest.mark.parametrize("check", ["oracle", "native", "device"])
def test_phase_vox(small_bunny, check):
    words, spec, info = cs.phase_vox(small_bunny, 32, check, iters=1)
    assert words.shape == (32, 32, 1) and info["diff_voxels"] == 0
    assert info["resolve"] == "sort"  # no GPU here


def test_phase_csg(small_bunny, torus_mesh):
    info = cs.phase_csg(small_bunny, torus_mesh, 32)
    assert float(info["union_ms"]) >= 0


def test_phase_jfa_native_and_sign(small_bunny):
    words, spec, _ = cs.phase_vox(small_bunny, 32, "device", iters=1)
    info = cs.phase_jfa(words, spec, "native")
    assert float(info["dist_diff_share"]) <= cs.JFA_DIFF_SHARE_MAX
    assert cs.phase_jfa(words, spec, "sign")["sign_mismatch"] == 0


def test_sdf_check_rejects_wrong_sign_and_distances():
    occ = np.zeros((4, 4, 4), bool)
    occ[1:3, 1:3, 1:3] = True
    sdf = np.where(occ, 1.0, -1.0).astype(np.float32)
    assert cs._sdf_check(sdf, occ, sdf)["sign_mismatch"] == 0
    with pytest.raises(AssertionError, match="sign"):
        cs._sdf_check(-sdf, occ)
    with pytest.raises(AssertionError, match="distances"):
        cs._sdf_check(sdf, occ, sdf * 2)


def test_phase_fit_loss_falls(small_bunny):
    info = cs.phase_fit(small_bunny, 32, steps=3)
    losses = [float(v) for v in info["losses"].split(",")]
    assert losses[-1] < losses[0]


def test_phase_soft_vs_cpu(small_bunny):
    info = cs.phase_soft_vs_cpu(small_bunny, 32)
    assert float(info["occ_max_err"]) == 0.0  # both sides are the CPU here


def test_phase_cli_names_the_path(small_bunny, torus_mesh):
    info = cs.phase_cli(small_bunny, torus_mesh, 32, "XlaVox", iters=2)
    assert len(info["vox_ms"].split(",")) == 2
    with pytest.raises(AssertionError, match="TritonVox"):
        cs.phase_cli(small_bunny, torus_mesh, 32, "TritonVox", iters=1)


def test_sharded_phases_on_four_cpu_devices(small_bunny):
    dmesh = cs._zmesh(4)
    assert cs.phase_sharded_vox(small_bunny, 32, dmesh)["diff_voxels"] == 0
    assert cs.phase_sharded_jfa(small_bunny, 32, dmesh)["sign_mismatch"] == 0
    cs.phase_sharded_fit(small_bunny, 32, dmesh)
    info = cs.phase_sharded_jfa_wide(64, dmesh)
    assert len(info["per_card_peak_bytes"].split(",")) == 4


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) == 1
    out = capsys.readouterr()
    assert "no GPU" in out.err
    assert not any(line.startswith("{") for line in out.out.splitlines())


def test_report_line_names_card(capsys):
    rep = cs.Report("Card X, 700.00 W")
    with rep.phase("p") as info:
        info["k"] = 1
    line = capsys.readouterr().out.strip()
    assert line.startswith("phase=p ok time_s=")
    assert 'card="Card X, 700.00 W"' in line and line.endswith("k=1")
    json.dumps({"ok": True})  # the contract's last line is plain JSON


@pytest.mark.gpu
def test_phase_resolve_on_gpu(gpu_device, small_bunny):
    info = cs.phase_resolve(small_bunny, 64, iters=2)
    assert float(info["atomic_resolve_ms"]) > 0
