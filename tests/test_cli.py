"""CLI end-to-end: flag surface, profiling stdout contract, exports."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {
    **os.environ,
    "JAX_PLATFORMS": "cpu",
    "PYTHONPATH": ROOT,
}


def run_cli(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "voxtpu.cli", *args, "--device", "cpu"],
        capture_output=True, text=True, cwd=cwd, env=ENV, timeout=600,
    )


def test_cli_voxelize_export(tmp_path, obj_files):
    r = run_cli(
        [obj_files["sphere"], "-n", "32", "-t", "1", "-e",
         "--out-dir", str(tmp_path / "out")],
        cwd=str(tmp_path),
    )
    assert r.returncode == 0, r.stderr
    # profiling stdout contract: "[Label]: X ms"
    assert re.search(r"\[XlaVox\(sphere\.obj\)\]: [\d.]+ ms", r.stdout), r.stdout
    assert (tmp_path / "out" / "xla_sphere.obj").exists()


def test_cli_csg_and_sdf(tmp_path, obj_files):
    r = run_cli(
        [obj_files["sphere"], obj_files["torus"], "-n", "32", "-t", "1",
         "-p", "1", "-s", "-e", "-o", "merged.obj",
         "--out-dir", str(tmp_path / "out")],
        cwd=str(tmp_path),
    )
    assert r.returncode == 0, r.stderr
    assert re.search(r"\[XlaCSG\]: [\d.]+ ms", r.stdout)
    assert re.search(r"\[XlaJFA\]: [\d.]+ ms", r.stdout)
    assert (tmp_path / "out" / "csg_vox_xla_merged.obj").exists()
    assert (tmp_path / "out" / "sdf_xla_merged.obj").exists()
    assert (tmp_path / "out" / "sdf_point_cloud_xla_merged.obj").exists()


def test_cli_benchmark_mode(tmp_path, obj_files):
    r = run_cli(
        [obj_files["d20"], "-n", "32", "-t", "1", "-m", "3", "-p", "1"],
        cwd=str(tmp_path),
    )
    assert r.returncode == 0, r.stderr
    # 3 iterations -> 3 main vox lines
    assert len(re.findall(r"\[XlaVox\(d20\.obj\)\]", r.stdout)) == 3


def test_cli_reference_backend(tmp_path, obj_files):
    r = run_cli(
        [obj_files["d20"], "-n", "32", "-t", "0"],
        cwd=str(tmp_path),
    )
    assert r.returncode == 0, r.stderr
    assert re.search(r"\[RefVox\(d20\.obj\)\]", r.stdout)


def test_cli_errors(tmp_path, obj_files):
    r = run_cli([], cwd=str(tmp_path))
    assert r.returncode != 0
    # -b (the removed kernel's tile rows) is gone: no kept kernel has a
    # block size for it to set.
    r = run_cli([obj_files["d20"], "-b", "17"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert "unrecognized arguments: -b" in r.stderr


def test_cli_type2_maps_to_xla(capsys, obj_files, tmp_path):
    """-t 2 (the reference's tiled backend) runs the XLA path; off a GPU
    its vox resolve is the sort-based one, labelled XlaVox, and its JFA
    and CSG are XLA's."""
    from voxtpu import cli

    assert cli.BACKENDS[2] == "xla" and cli.BACKENDS[1] == "xla"
    rc = cli.main([obj_files["sphere"], obj_files["torus"], "-n", "32",
                   "-t", "2", "-p", "3", "-s", "-m", "2",
                   "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert len(re.findall(r"\[XlaVox\(sphere\.obj\)\]", out)) == 2
    assert re.search(r"\[XlaVox::processing\]: [\d.]+ ms", out)
    assert re.search(r"\[XlaCSG\]", out) and re.search(r"\[XlaJFA\]", out)
    assert "Triton" not in out
