#!/usr/bin/env python
"""Benchmark runner: sweep meshes x backends x grid sizes through the CLI.

Keeps the reference harness's observable contract (SURVEY.md §3.5): runs
the CLI as a subprocess, scrapes ``[Label]: X ms`` profiling lines from
stdout, groups hierarchical ``Parent::Child`` labels into snake_case CSV
columns, and writes one CSV per (mesh, algorithm) under --output.

Usage:
    python scripts/benchmarks.py --meshes sphere torus bunny \
        --types 1 3 --minsize 32 --maxsize 256 --niter 5 --output out/bench

Meshes are generated by name (sphere, torus, d20, bunny) or read from
``.obj`` paths / ``--folder``. The CLI runs in this process by default
(``voxtpu.cli.main`` with redirected stdout — same scrape contract), so
one process holds the device for the whole matrix; a second process on
one card would fail for want of memory. ``--subprocess`` spawns the CLI
per config instead, as the reference's harness does; the parent then
stays off JAX.
"""

from __future__ import annotations

import argparse
import csv
import os
import re
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LINE_RE = re.compile(r"\[(.*)\]: ([\d.]+) ms")


def to_snake_case(name: str) -> str:
    name = name.replace("::", "__")
    name = re.sub(r"(?<=[a-z0-9])([A-Z])", r"_\1", name)
    name = re.sub(r"([A-Z]+)([A-Z][a-z])", r"\1_\2", name)
    return re.sub(r"__+", "__", name.lower())


def scrape(stdout: str):
    """Yield per-iteration {column: ms} dicts keyed by main label."""
    per_main = defaultdict(list)
    current = {}
    for line in stdout.splitlines():
        m = LINE_RE.search(line)
        if not m:
            continue
        label = re.sub(r"\s*\(.*?\)", "", m.group(1))
        main = to_snake_case(label.split("::")[0])
        full = to_snake_case(label)
        value = float(m.group(2))
        current[full] = current.get(full, 0.0) + value
        if "__" not in full:  # main line closes one iteration
            per_main[main].append(dict(current))
            current.clear()
    return per_main


def _run_config(argv: list[str], in_process: bool) -> str | None:
    """One CLI config; returns its stdout text, or None on failure."""
    if not in_process:
        cmd = [sys.executable, "-m", "voxtpu.cli"] + argv
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            print(f"  FAILED rc={r.returncode}\n{r.stderr[-2000:]}",
                  file=sys.stderr)
            return None
        return r.stdout

    import contextlib
    import io
    import traceback

    from voxtpu.cli import main as cli_main

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
    except Exception:
        print(f"  FAILED (in-process)\n{traceback.format_exc()[-2000:]}",
              file=sys.stderr)
        return None
    if rc != 0:
        print(f"  FAILED rc={rc}", file=sys.stderr)
        return None
    return buf.getvalue()


def _mesh_file(name_or_path: str, folder: Path) -> Path:
    """An .obj path for a generated mesh name (written under `folder`),
    or the path itself."""
    if name_or_path.endswith(".obj"):
        return Path(name_or_path)
    from voxtpu.mesh.generate import mesh_by_name
    from voxtpu.mesh.obj_io import export_mesh

    path = folder / f"{name_or_path}.obj"
    export_mesh(path, mesh_by_name(name_or_path))
    return path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--niter", type=int, default=5)
    ap.add_argument("--folder", default=None,
                    help="directory of .obj files to sweep")
    ap.add_argument("--meshes", nargs="*", default=None,
                    help="generated mesh names or .obj files "
                         "(default: sphere torus d20 bunny)")
    ap.add_argument("--minsize", type=int, default=32)
    ap.add_argument("--maxsize", type=int, default=128)
    ap.add_argument("--output", default="out/benchmarks")
    ap.add_argument("--no-sdf", action="store_true")
    ap.add_argument("--types", nargs="+", default=["1", "2"],
                    help="backends: 0=reference 1=xla 2=xla 3=native")
    ap.add_argument("--device", default=None)
    ap.add_argument("--subprocess", action="store_true",
                    help="spawn the CLI per config (the parent stays off "
                         "JAX) instead of calling voxtpu.cli.main here")
    args = ap.parse_args()

    out_root = Path(args.output)
    out_root.mkdir(parents=True, exist_ok=True)

    if args.folder:
        meshes = sorted(Path(args.folder).glob("*.obj"))
    else:
        meshes = [_mesh_file(m, out_root / "meshes")
                  for m in (args.meshes or ["sphere", "torus", "d20", "bunny"])]

    sizes = []
    s = args.minsize
    while s <= args.maxsize:
        sizes.append(s)
        s *= 2

    for mesh in meshes:
        all_data = defaultdict(dict)  # main -> size -> [iteration dicts]
        for t in args.types:
            for size in sizes:
                argv = [str(mesh), "-n", str(size), "-t", str(t),
                        "-m", str(args.niter), "-p", "1"]
                if not args.no_sdf and size <= 512:
                    argv.append("-s")
                if args.device:
                    argv += ["--device", args.device]
                print("Running:", " ".join(argv), flush=True)
                stdout = _run_config(argv, not args.subprocess)
                if stdout is None:
                    continue
                for main, iters in scrape(stdout).items():
                    all_data[main].setdefault(size, []).extend(iters)

        for main, by_size in all_data.items():
            cols = sorted({k for its in by_size.values() for it in its for k in it})
            out_dir = out_root / mesh.stem
            out_dir.mkdir(parents=True, exist_ok=True)
            with open(out_dir / f"{mesh.stem}_{main}.csv", "w", newline="") as fh:
                w = csv.writer(fh)
                w.writerow(["size"] + cols)
                for size in sorted(by_size):
                    for it in by_size[size]:
                        w.writerow([size] + [it.get(c, "") for c in cols])
    return 0


if __name__ == "__main__":
    sys.exit(main())
