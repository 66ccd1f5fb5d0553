"""Recall-vs-threshold curves of the per-object pose errors.

The port's own copy of ``rdpn6d_tpu/evaluation/plots.py``: one CSV per
error type (rows are thresholds, columns the objects and their MEAN),
written next to the BOP results CSV, plus a PNG of each when matplotlib
imports (the JAX package's rule).
"""

from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger("rdpn6d")

# error key -> (threshold grid builder, unit label)
# ad/add/adi thresholds are fractions of the object diameter (the classic
# "0.1d" sweep); re in degrees; te in meters; proj in pixels.
_CURVES = {
    "ad": (lambda d: np.linspace(0.0, 0.5, 101) * d, "diameter_frac"),
    "add": (lambda d: np.linspace(0.0, 0.5, 101) * d, "diameter_frac"),
    "adi": (lambda d: np.linspace(0.0, 0.5, 101) * d, "diameter_frac"),
    "re": (lambda d: np.linspace(0.0, 60.0, 121), "deg"),
    "te": (lambda d: np.linspace(0.0, 0.1, 101), "m"),
    "proj": (lambda d: np.linspace(0.0, 50.0, 101), "px"),
}


def recall_curve(errors: np.ndarray, thresholds: np.ndarray,
                 n_gts: int | None = None) -> np.ndarray:
    """recall[t] = fraction of GT instances with error < thresholds[t].

    ``errors`` may contain inf rows (padded failures); the denominator is
    ``n_gts`` when given else len(errors). The production caller
    (eval_runner) passes errors that PoseEvaluator already inf-padded to
    the GT count, so it omits ``n_gts`` — pass it only for raw,
    un-padded error arrays (passing it WITH padded arrays would double-
    count misses in the denominator).
    """
    denom = max(int(n_gts) if n_gts is not None else len(errors), 1)
    return (np.asarray(errors)[None, :]
            < thresholds[:, None]).sum(axis=1) / denom


def dump_recall_curves(errors_by_obj: dict[str, dict[str, np.ndarray]],
                       diameters: dict[str, float],
                       out_dir: str,
                       n_gts: dict[str, int] | None = None,
                       png: bool = True) -> list[str]:
    """Write one CSV per error type: rows = thresholds, columns = objects
    + MEAN. Returns the written paths. Curves normalize ad/add/adi
    thresholds by each object's diameter, so the columns share an x-axis
    of diameter fractions (the reference plots the same normalization,
    eval_plots.py)."""
    os.makedirs(out_dir, exist_ok=True)
    objs = sorted(errors_by_obj)
    written = []
    for key, (thr_fn, unit) in _CURVES.items():
        if not any(key in errors_by_obj[o] for o in objs):
            continue
        # normalized grid: identical row index for every object
        grid = thr_fn(1.0)
        cols = {}
        for o in objs:
            if key not in errors_by_obj[o]:
                continue
            d = diameters.get(o, 1.0)
            thr = thr_fn(d) if unit == "diameter_frac" else grid
            cols[o] = recall_curve(
                np.asarray(errors_by_obj[o][key], np.float64), thr,
                n_gts.get(o) if n_gts else None)
        if not cols:
            continue
        mean = np.mean(np.stack(list(cols.values())), axis=0)
        path = os.path.join(out_dir, f"recall_{key}.csv")
        header = f"threshold_{unit}," + ",".join(cols) + ",MEAN"
        body = np.column_stack([grid, *cols.values(), mean])
        np.savetxt(path, body, delimiter=",", header=header, comments="",
                   fmt="%.6g")
        written.append(path)
        if png:
            written += _maybe_png(path, grid, cols, mean, key, unit)
    logger.info(f"recall curves: {len(written)} files in {out_dir}")
    return written


def _maybe_png(csv_path: str, grid, cols, mean, key, unit) -> list[str]:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return []
    fig, ax = plt.subplots(figsize=(5, 4))
    for o, r in cols.items():
        ax.plot(grid, r, lw=0.8, alpha=0.7, label=o)
    ax.plot(grid, mean, "k-", lw=2.0, label="MEAN")
    ax.set_xlabel(f"{key} threshold ({unit})")
    ax.set_ylabel("recall")
    ax.set_ylim(0, 1.02)
    ax.grid(alpha=0.3)
    if len(cols) <= 12:
        ax.legend(fontsize=6)
    png_path = csv_path[:-4] + ".png"
    fig.tight_layout()
    fig.savefig(png_path, dpi=120)
    plt.close(fig)
    return [png_path]
