"""bench.py and the reference-style benchmark runner, at tiny sizes on
the CPU (bench.py's timings mean something only on the card)."""

import csv
import sys

import pytest

import bench


@pytest.fixture(scope="module")
def small_bunny():
    from voxtpu.mesh.generate import bunny

    return bunny(3000)


def test_benchmarks_runner_in_process(tmp_path, monkeypatch):
    """The runner drives voxtpu.cli.main in this process by default and
    writes one CSV per (mesh, algorithm) from the scraped scopes."""
    import scripts.benchmarks as bm

    monkeypatch.setattr(
        sys, "argv",
        ["benchmarks", "--meshes", "d20",
         "--types", "1", "--minsize", "32", "--maxsize", "32",
         "--niter", "2", "--no-sdf", "--output", str(tmp_path)])
    assert bm.main() == 0
    vox_csv = tmp_path / "d20" / "d20_xla_vox.csv"
    assert vox_csv.exists()
    with open(vox_csv) as fh:
        rows = list(csv.reader(fh))
    assert rows[0][0] == "size"
    assert "xla_vox" in rows[0]
    assert "xla_vox__processing" in rows[0]
    assert len(rows) == 3  # header + 2 iterations
    assert all(r[0] == "32" for r in rows[1:])


def test_bench_refuses_without_gpu(capsys):
    assert bench.main(["--ops", "csg", "--n", "32", "--faces", "3000"]) == 1
    out = capsys.readouterr()
    assert "no GPU" in out.err and out.out == ""


def test_bench_vox_paths_agree(small_bunny):
    out = bench._vox(small_bunny, 32, iters=1)
    assert out["resolve"] == "sort" and out["fragments"] > 0
    assert out["value"] > 0 and out["xla_sort_resolve_ms"] > 0


@pytest.mark.parametrize("bw", [None, 3.35e12])
def test_bench_jfa_and_csg_bounds(small_bunny, bw):
    jfa = bench._jfa(small_bunny, 32, 1, bw)
    csg = bench._csg(small_bunny, 32, 1, bw)
    assert jfa["flood_steps"] == 5 and jfa["step_ms"] > 0
    if bw is None:  # no peak assumed for an unknown device
        assert jfa["step_byte_bound_share"] is None
        assert csg["byte_bound_share"] is None
    else:
        assert jfa["step_byte_bound_ms"] == pytest.approx(2 * 32**3 * 4 / bw * 1e3)
        assert csg["byte_bound_share"] > 0


def test_bench_softvox_fwd_bwd(small_bunny):
    out = bench._softvox(small_bunny, 32, 1)
    assert out["soft_fragments"] > 0 and out["value"] > 0
