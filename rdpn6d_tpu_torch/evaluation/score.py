"""Scoring: threshold recalls and AUC curves over pose errors.

The port's own copy of ``rdpn6d_tpu/evaluation/score.py`` (numpy):
``ad_2/5/10`` (ADD(-S) under 2/5/10% of the diameter), ``re/te/proj_2/5/10``
(degrees / centimetres / pixels), PoseCNN's AUC up to 10 cm and the
reference's VOC-style AUC over 1..10 cm, and the MEAN row over objects.
"""

from __future__ import annotations

import numpy as np


def recall_at(errors: np.ndarray, threshold: float) -> float:
    errors = np.asarray(errors, np.float64)
    if errors.size == 0:
        return 0.0
    return float(np.mean(errors < threshold) * 100.0)


def pose_recalls(ad_errors, re_errors, te_errors, proj_errors,
                 diameter: float) -> dict[str, float]:
    """The custom evaluator's per-object metric table
    (gdrn_custom_evaluator.py:541-560)."""
    out = {}
    for pct in (2, 5, 10):
        out[f"ad_{pct}"] = recall_at(np.asarray(ad_errors),
                                     diameter * pct / 100.0)
    for thr in (2, 5, 10):
        out[f"re_{thr}"] = recall_at(np.asarray(re_errors), thr)
        out[f"te_{thr}"] = recall_at(np.asarray(te_errors), thr / 100.0)
        out[f"proj_{thr}"] = recall_at(np.asarray(proj_errors), thr)
        both = (np.asarray(re_errors) < thr) & \
               (np.asarray(te_errors) < thr / 100.0)
        out[f"rete_{thr}"] = float(np.mean(both) * 100.0) if both.size else 0.0
    return out


def auc_posecnn(errors_m: np.ndarray, max_thr_m: float = 0.1,
                step: float = 0.001) -> float:
    """PoseCNN-style AUC (%) of accuracy vs threshold in [0, max_thr]."""
    errors = np.asarray(errors_m, np.float64)
    if errors.size == 0:
        return 0.0
    thrs = np.arange(0.0, max_thr_m + 1e-9, step)
    acc = np.array([np.mean(errors < t) for t in thrs])
    return float(np.trapezoid(acc, thrs) / max_thr_m * 100.0)


def auc_voc(errors_cm: np.ndarray, thresholds_cm=None) -> float:
    """The reference's AUCad: mean recall over thresholds 1..10 cm
    (eval_pose_results_more.py:81-85)."""
    errors = np.asarray(errors_cm, np.float64)
    if errors.size == 0:
        return 0.0
    if thresholds_cm is None:
        thresholds_cm = np.linspace(1.0, 10.0, 10)
    return float(np.mean([np.mean(errors < t) for t in thresholds_cm])
                 * 100.0)


def summarize_objects(per_obj: dict[str, dict[str, float]]
                      ) -> dict[str, float]:
    """MEAN row over objects (the tables' last row)."""
    if not per_obj:
        return {}
    keys = next(iter(per_obj.values())).keys()
    return {k: float(np.mean([v[k] for v in per_obj.values()]))
            for k in keys}
