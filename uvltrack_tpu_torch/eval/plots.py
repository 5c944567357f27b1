"""Success / precision / normalized-precision plot rendering (a copy of
uvltrack_tpu/eval/plots.py; matplotlib is imported where a plot is drawn,
so a machine without it imports this module).

Parity with lib/test/analysis/plot_results.py:215-316: per-tracker curves over
the standard threshold grids, AUC/P in the legend, saved as png+pdf.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from .metrics import THRESH_CENTER, THRESH_CENTER_NORM, THRESH_OVERLAP

_PLOT_SPECS = {
    "success": dict(xlabel="Overlap threshold", ylabel="Overlap Precision [%]",
                    xlim=(0, 1.0), title="Success plot", grid=THRESH_OVERLAP,
                    score="AUC"),
    "precision": dict(xlabel="Location error threshold [pixels]",
                      ylabel="Distance Precision [%]", xlim=(0, 50),
                      title="Precision plot", grid=THRESH_CENTER,
                      score="Precision"),
    "norm_precision": dict(xlabel="Location error threshold",
                           ylabel="Distance Precision [%]", xlim=(0, 0.5),
                           title="Normalized Precision plot",
                           grid=THRESH_CENTER_NORM, score="NormPrec"),
}


def plot_curves(tracker_curves: Dict[str, List[dict]], out_dir: str,
                plot_types=("success", "precision", "norm_precision")):
    """tracker_curves: {tracker_name: [per-sequence curve dicts]} (from
    metrics.sequence_curves). Writes <out_dir>/<plot_type>_plot.{png,pdf}."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for ptype in plot_types:
        spec = _PLOT_SPECS[ptype]
        fig, ax = plt.subplots(figsize=(6, 5))
        scored = []
        for name, curves in tracker_curves.items():
            mean_curve = np.stack([c[ptype] for c in curves]).mean(0) * 100.0
            if ptype == "success":
                score = mean_curve.mean()
            else:
                score = mean_curve[20]
            scored.append((score, name, mean_curve))
        for score, name, curve in sorted(scored, reverse=True):
            ax.plot(spec["grid"], curve, linewidth=2,
                    label=f"{name} [{score:.1f}]")
        ax.set_xlabel(spec["xlabel"])
        ax.set_ylabel(spec["ylabel"])
        ax.set_xlim(spec["xlim"])
        ax.set_ylim(0, 100)
        ax.set_title(spec["title"])
        ax.grid(True, alpha=0.3)
        ax.legend(loc="lower left" if ptype == "success" else "lower right",
                  fontsize=9)
        for ext in ("png", "pdf"):
            path = os.path.join(out_dir, f"{ptype}_plot.{ext}")
            fig.savefig(path, dpi=150, bbox_inches="tight")
            paths.append(path)
        plt.close(fig)
    return paths


def plot_results_dirs(results_dirs: Dict[str, str], dataset, out_dir: str,
                      **kwargs):
    """Score saved result dirs ({name: dir}) against a SequenceList and plot."""
    from .metrics import sequence_curves

    tracker_curves = {}
    for name, rdir in results_dirs.items():
        curves = []
        for seq in dataset:
            path = os.path.join(rdir, f"{seq.name}.txt")
            if not os.path.isfile(path):
                continue
            from .datasets import load_text
            pred = load_text(path)
            curves.append(sequence_curves(pred.reshape(-1, 4),
                                          seq.ground_truth_rect, seq.dataset,
                                          seq.target_visible))
        if curves:
            tracker_curves[name] = curves
    return plot_curves(tracker_curves, out_dir, **kwargs)


def plot_got_success(json_files: Dict[str, str], out_dir: str):
    """Success plot from GOT-10k leaderboard json reports
    (plot_results.py:381-439): each report carries a 101-bin succ_curve and
    an 'ao' score, either at the top level of the single tracker entry or
    under 'overall'. Returns the written file paths."""
    import json

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    thresholds = np.linspace(0.0, 1.0, 101)
    fig, ax = plt.subplots(figsize=(6, 5))
    scored = []
    for name, path in json_files.items():
        with open(path) as f:
            data = json.load(f)
        if len(data) != 1:
            raise ValueError(f"expected a single tracker entry in {path}")
        entry = data[next(iter(data))]
        if "succ_curve" in entry:
            curve, ao = entry["succ_curve"], entry["ao"]
        elif "overall" in entry and "succ_curve" in entry["overall"]:
            curve, ao = entry["overall"]["succ_curve"], entry["overall"]["ao"]
        else:
            raise ValueError(f"invalid GOT-10k report {path}")
        scored.append((float(ao) * 100.0, name, np.asarray(curve) * 100.0))
    for score, name, curve in sorted(scored, reverse=True):
        ax.plot(thresholds, curve, linewidth=2, label=f"{name} [{score:.1f}]")
    ax.set_xlabel("Overlap threshold")
    ax.set_ylabel("Overlap Precision [%]")
    ax.set_xlim(0, 1.0)
    ax.set_ylim(0, 100)
    ax.set_title("GOT-10k Success")
    ax.grid(True, alpha=0.3)
    ax.legend(loc="lower left", fontsize=9)
    paths = []
    for ext in ("png", "pdf"):
        p = os.path.join(out_dir, f"got_success_plot.{ext}")
        fig.savefig(p, dpi=150, bbox_inches="tight")
        paths.append(p)
    plt.close(fig)
    return paths
