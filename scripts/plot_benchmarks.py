#!/usr/bin/env python
"""Plot benchmark CSVs: runtime-vs-size comparison lines and per-stage
stacked bars (T2-T4 analog of the reference's plotting scripts:
`scripts/plot_comparison.py`, `scripts/plot_bar_diagram.py`, driven by
`scripts/generate_plots.py`).

    python scripts/plot_benchmarks.py out/benchmarks/sphere --out out/images/sphere

Matches the reference driver's full output matrix per mesh:
- `*_comparison_memory_<subset>.png` — main-column means (incl. every
  sub-scope), per backend-subset (`generate_plots.py:15-130`).
- `*_comparison_no_memory_<subset>.png` — main column minus the
  excluded sub-scopes (`plot_comparison.py:26-36` subtracts
  `main__<label>`; the reference excludes its `memory` PCIe-copy scope
  — this pipeline's one-time overhead scope is `planning`, so both
  labels are excluded by default and whichever exists is subtracted).
- `*_<algo>_bar.png` / `*_<algo>_bar_no_memory.png` — per-stage bars,
  one per (mesh, algorithm) CSV (the reference's bar_diagram outputs;
  the no_memory variant drops the excluded stage columns).
- Backend subsets mirror the reference's index code (0 = sequential /
  openmp host baseline, 1 = naive device, 2 = tiled device):
  vox 012/12/01 with 0 = ref; jfa 012/12/01 with 0 = native (the
  reference compares openmp, `generate_plots.py:82-130`); csg 12.
"""

from __future__ import annotations

import argparse
import csv
from collections import defaultdict
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

# Reference subset matrix (generate_plots.py): ordered backend names per
# op; a subset like "012" picks those positions when present.
_SUBSET_ORDER = {
    "vox": ["ref", "xla", "pallas"],
    "jfa": ["native", "xla", "pallas"],
    "csg": [None, "native", "xla"],  # csg has no position-0 plot
}
_SUBSETS = {
    "vox": ("012", "12", "01"),
    "jfa": ("012", "12", "01"),
    "csg": ("12",),
}
EXCLUDE_DEFAULT = ("memory", "planning")


def load_csv(path: Path):
    with open(path) as fh:
        rows = list(csv.reader(fh))
    header = rows[0]
    by_size = defaultdict(list)
    for row in rows[1:]:
        size = int(row[0])
        vals = {h: (float(v) if v else np.nan) for h, v in zip(header[1:], row[1:])}
        by_size[size].append(vals)
    return by_size


def robust_mean(vals):
    """Mean excluding the max sample, per column independently —
    the reference's exact semantics (plot_comparison.py:41-45); the
    dropped sample is usually but not necessarily the warm-up."""
    vals = [v for v in vals if np.isfinite(v)]
    if len(vals) > 2:
        vals = sorted(vals)[:-1]
    return float(np.mean(vals)) if vals else np.nan


def _main_col(by_size):
    sizes = sorted(by_size)
    cands = [c for c in by_size[sizes[0]][0] if "__" not in c]
    return cands[0] if cands else None


def _series(by_size, exclude=()):
    """Per-size robust means of the main column, minus excluded
    sub-scopes (subtraction happens per sample BEFORE the mean, the
    reference's order of operations)."""
    col = _main_col(by_size)
    if col is None:
        return [], []
    sizes = sorted(by_size)
    ys = []
    for s in sizes:
        samples = []
        for it in by_size[s]:
            v = it.get(col, np.nan)
            for label in exclude:
                sub = it.get(f"{col}__{label}")
                if sub is not None and np.isfinite(sub):
                    v = v - sub
            samples.append(v)
        ys.append(robust_mean(samples))
    return sizes, ys


def _comparison(algos, title, path, exclude=()):
    fig, ax = plt.subplots(figsize=(7, 4.5))
    plotted = 0
    for algo, by_size in algos:
        sizes, ys = _series(by_size, exclude)
        if sizes:
            ax.plot(sizes, ys, marker="o", label=algo)
            plotted += 1
    if not plotted:
        plt.close(fig)
        return False
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    ax.set_xlabel("grid size (voxels/side)")
    ax.set_ylabel("runtime (ms)")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def _bars(by_size, title, path, exclude=()):
    sizes = sorted(by_size)
    stage_cols = sorted(
        {c for s in sizes for it in by_size[s] for c in it if "__" in c}
    )
    stage_cols = [c for c in stage_cols if c.split("__", 1)[1] not in exclude]
    if not stage_cols:
        return False
    fig, ax = plt.subplots(figsize=(7, 4.5))
    bottom = np.zeros(len(sizes))
    for c in stage_cols:
        ys = np.array(
            [robust_mean([it.get(c, np.nan) for it in by_size[s]]) for s in sizes]
        )
        ys = np.nan_to_num(ys)
        ax.bar([str(s) for s in sizes], ys, bottom=bottom,
               label=c.split("__", 1)[1])
        bottom += ys
    ax.set_xlabel("grid size")
    ax.set_ylabel("runtime (ms)")
    ax.set_title(title)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("folder", help="per-mesh CSV folder from benchmarks.py")
    ap.add_argument("--out", default=None)
    ap.add_argument("--exclude-labels", nargs="+", default=list(EXCLUDE_DEFAULT),
                    help="sub-scope labels subtracted in the no_memory "
                         "variants (reference: plot_comparison.py "
                         "--exclude-labels memory)")
    args = ap.parse_args()
    # resolve(): running from inside the folder ('.') would make
    # folder.name empty and corrupt the algo-label strip below.
    folder = Path(args.folder).resolve()
    out = Path(args.out or folder / "plots")
    out.mkdir(parents=True, exist_ok=True)
    mesh = folder.name
    exclude = tuple(args.exclude_labels)

    csvs = sorted(folder.glob("*.csv"))
    groups = defaultdict(dict)  # op ('vox'|'jfa'|'csg') -> algo -> data
    for f in csvs:
        op_suffix = f.stem.split("_")[-1]
        # e.g. "sphere_pallas_vox" -> algo "pallas_vox" (keying by the
        # op suffix alone would collapse different backends' CSVs).
        algo = f.stem.replace(mesh + "_", "", 1)
        for op in ("vox", "jfa", "csg"):
            if op_suffix.endswith(op):
                groups[op][algo] = load_csv(f)

    written = 0
    for op, algos in groups.items():
        # Full-set comparison (round-1/2 output, kept: every backend
        # present, memory included).
        if _comparison(sorted(algos.items()), f"{mesh} {op} comparison",
                       out / f"{mesh}_{op}_comparison.png"):
            written += 1

        # Reference subset matrix x {memory, no_memory}.
        order = _SUBSET_ORDER[op]
        for code in _SUBSETS[op]:
            chosen = []
            for ch in code:
                backend = order[int(ch)]
                algo = f"{backend}_{op}" if backend else None
                if algo in algos:
                    chosen.append((algo, algos[algo]))
            if len(chosen) < 2:
                continue
            for tag, exc in (("memory", ()), ("no_memory", exclude)):
                if _comparison(chosen,
                               f"{mesh} {op} {tag} ({code})",
                               out / f"{mesh}_{op}_comparison_{tag}_{code}.png",
                               exc):
                    written += 1

        # Per-stage stacked bars x {memory, no_memory}.
        for algo, by_size in sorted(algos.items()):
            if _bars(by_size, f"{mesh} {algo} stages",
                     out / f"{mesh}_{algo}_bar.png"):
                written += 1
            if _bars(by_size, f"{mesh} {algo} stages (no_memory)",
                     out / f"{mesh}_{algo}_bar_no_memory.png", exclude):
                written += 1

    print(f"{written} plots written to {out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
