"""BOP19 localization scoring: per-error average recall and the final AR.

The port's own copy of ``rdpn6d_tpu/evaluation/bop_score.py`` (numpy): for
each (scene, image, object) target, the top-``inst_count`` estimates by
score are matched greedily to GT instances by lowest error, separately per
threshold, and the recalls averaged:

    AR_mssd = mean over thresholds 0.05..0.5 of the diameter
    AR_mspd = mean over thresholds 5..50 px (scaled by image width / 640)
    AR_vsd  = mean over taus 0.05..0.5 and thresholds 0.05..0.5
    AR      = (AR_mssd + AR_mspd) / 2, or with AR_vsd the mean of three

``make_vsd_error_fn`` renders depth with the port's host rasterizer
(``ops/rasterizer.py``), each pose once a pass through an LRU cache.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable

import numpy as np


def match_poses_bop(errors: np.ndarray,
                    thr_per_gt: np.ndarray) -> list[tuple[int, int]]:
    """BOP-toolkit matching for ONE threshold (pose_matching.py:9-93).

    errors [n_est, n_gt] with estimate rows ALREADY in descending-score
    order; thr_per_gt [n_gt] absolute threshold per GT. Estimates are
    processed in score order; each takes the unmatched GT with the lowest
    sub-threshold error. Returns (est, gt) pairs.
    """
    if errors.size == 0:
        return []
    pairs = []
    gt_used = np.zeros(errors.shape[1], bool)
    for e in range(errors.shape[0]):
        cand = np.where(~gt_used & (errors[e] < thr_per_gt))[0]
        if cand.size == 0:
            continue
        g = int(cand[np.argmin(errors[e][cand])])
        gt_used[g] = True
        pairs.append((e, g))
    return pairs


def match_counts_batch(errors: np.ndarray,
                       thr_mat: np.ndarray) -> np.ndarray:
    """Greedy BOP matching VECTORIZED over thresholds.

    errors [E, G] (estimate rows in descending-score order); thr_mat
    [T, G] absolute per-GT thresholds for T independent match passes.
    Returns match counts [T] — exactly ``len(match_poses_bop(errors,
    thr_mat[t]))`` for each t, but with one numpy pass per estimate row
    instead of T python greedy loops (the reference runs the full greedy
    per threshold, pose_matching.py:9-93; a VSD scoring pass needs
    |taus| x |thresholds| = 100 of them per target).
    """
    if errors.size == 0:
        return np.zeros(thr_mat.shape[0], np.int64)
    E, G = errors.shape
    T = thr_mat.shape[0]
    used = np.zeros((T, G), bool)
    counts = np.zeros(T, np.int64)
    rows = np.arange(T)
    for e in range(E):
        cand = ~used & (errors[e][None, :] < thr_mat)      # [T, G]
        masked = np.where(cand, errors[e][None, :], np.inf)
        sel = masked.argmin(axis=1)                        # lowest error
        ok = cand[rows, sel]
        used[rows[ok], sel[ok]] = True
        counts += ok
    return counts


def score_error_recalls(
    estimates: list[dict[str, Any]],
    gts: dict[tuple[int, int], list[dict[str, Any]]],
    targets: list[dict[str, Any]],
    error_fn: Callable[[dict, dict], float],
    thresholds: list[float],
    normalize_by_diameter: bool = False,
) -> dict[str, float]:
    """Generic BOP localization recall.

    estimates: [{scene_id, im_id, obj_id, score, R, t}]
    gts: {(scene_id, im_id): [{obj_id, R, t, diameter, ...}]}
    targets: [{scene_id, im_id, obj_id, inst_count}]
    error_fn(est, gt) -> scalar error (same unit as thresholds; may consult
    gt["diameter"] for normalized thresholds).
    Returns {"recall": mean over thresholds, "per_threshold": [...]}-style
    flat dict.
    """
    est_by_key: dict[tuple[int, int, int], list[dict]] = defaultdict(list)
    for e in estimates:
        est_by_key[(e["scene_id"], e["im_id"], e["obj_id"])].append(e)

    n_variants = None  # error_fn may return a vector (e.g. VSD per tau)
    per_target = []
    n_total = 0
    for tgt in targets:
        key = (tgt["scene_id"], tgt["im_id"], tgt["obj_id"])
        n_inst = int(tgt.get("inst_count", 1))
        n_total += n_inst
        gt_list = [g for g in gts.get((key[0], key[1]), [])
                   if g["obj_id"] == key[2]]
        ests = sorted(est_by_key.get(key, []),
                      key=lambda e: -e.get("score", 1.0))[:n_inst]
        if not ests or not gt_list:
            continue
        err = np.array([[np.atleast_1d(error_fn(e, g)) for g in gt_list]
                        for e in ests], np.float64)   # [E, G, V]
        n_variants = err.shape[-1]
        diam = np.array([g["diameter"] for g in gt_list]) \
            if normalize_by_diameter else np.ones(len(gt_list))
        per_target.append((err, diam))

    n_variants = n_variants or 1
    # BOP19 matching runs SEPARATELY per threshold (and per error variant):
    # estimates in descending-score order each take the unmatched GT with
    # the lowest sub-threshold error (pose_matching.py:9-93). The error
    # matrices are computed ONCE per target above; the per-threshold
    # greedy runs vectorized over the whole threshold grid.
    thr_arr = np.asarray(thresholds, np.float64)
    n_correct = np.zeros((n_variants, len(thresholds)))
    for err, diam in per_target:
        thr_mat = thr_arr[:, None] * diam[None, :]    # [T, G]
        for v in range(err.shape[-1]):
            n_correct[v] += match_counts_batch(err[..., v], thr_mat)
    recalls = n_correct / max(n_total, 1)             # [V, T]
    mean_per_thr = recalls.mean(axis=0)
    out = {f"recall@{t}": float(r)
           for t, r in zip(thresholds, mean_per_thr)}
    out["AR"] = float(np.mean(recalls))
    return out


def make_vsd_error_fn(meshes: dict[int, tuple[np.ndarray, np.ndarray]],
                      depth_loader: Callable[[int, int], np.ndarray],
                      diameters: dict[int, float],
                      delta: float = 15.0 / 1000.0,
                      taus: tuple[float, ...] = tuple(
                          float(t) for t in np.arange(0.05, 0.51, 0.05)),
                      render_cache: int = 64,
                      ) -> Callable[[dict, dict], np.ndarray]:
    """VSD error_fn for ``score_error_recalls`` / ``bop19_average_recalls``.

    meshes: {obj_id: (verts [V,3], faces [F,3])}; depth_loader returns the
    scene's test depth (m) for (scene_id, im_id). Renders are memoized on
    (object, pose, camera, size): a GT's render serves every estimate of
    its target, and an estimate's every GT instance, so a pass renders
    each pose once. Returns the error vector over the BOP19 taus
    0.05..0.5; ``score_error_recalls`` averages recalls over taus x
    thresholds. ``err.render_cache_info`` reads the cache's counters.
    """
    from functools import lru_cache

    from ..ops.rasterizer import render_mesh
    from .bop_errors import vsd_from_depths

    @lru_cache(maxsize=render_cache)
    def _render(oid: int, R_b: bytes, t_b: bytes, K_b: bytes,
                H: int, W: int) -> np.ndarray:
        v, f = meshes[oid]
        d, _ = render_mesh(
            v, f, np.frombuffer(K_b, np.float64).reshape(3, 3),
            np.frombuffer(R_b, np.float64).reshape(3, 3),
            np.frombuffer(t_b, np.float64), H, W)
        return d

    def key(a) -> bytes:
        return np.ascontiguousarray(a, np.float64).tobytes()

    def err(est: dict, gt: dict) -> np.ndarray:
        depth = depth_loader(est["scene_id"], est["im_id"])
        H, W = depth.shape
        oid = int(gt["obj_id"])
        K_b = key(gt["K"])
        d_est = _render(oid, key(est["R"]), key(est["t"]), K_b, H, W)
        d_gt = _render(oid, key(gt["R"]), key(gt["t"]), K_b, H, W)
        return np.asarray(vsd_from_depths(
            d_est, d_gt, depth, delta=delta, taus=taus,
            diameter=diameters[oid]))

    err.render_cache_info = _render.cache_info
    return err


def bop19_average_recalls(
    estimates: list[dict[str, Any]],
    gts: dict[tuple[int, int], list[dict[str, Any]]],
    targets: list[dict[str, Any]],
    models: dict[int, np.ndarray],
    sym_rots: dict[int, np.ndarray],
    diameters: dict[int, float],
    im_width: int = 640,
    with_vsd: Callable | None = None,
    sym_trans: dict[int, np.ndarray] | None = None,
) -> dict[str, float]:
    """MSSD/MSPD (and optional VSD) average recalls + combined AR."""
    # host numpy per pair: the matching loop is python anyway, and one
    # device dispatch + float() sync PER (est, gt) pair made full-split
    # BOP19 scoring relay-latency-bound (~ms each vs ~us of host math)
    from .bop_errors import mspd_np, mssd_np

    def _st(oid):
        return None if sym_trans is None else np.asarray(sym_trans[oid])

    def e_mssd(est, gt):
        oid = gt["obj_id"]
        return mssd_np(
            np.asarray(est["R"]), np.asarray(est["t"]),
            np.asarray(gt["R"]), np.asarray(gt["t"]),
            np.asarray(models[oid]), np.asarray(sym_rots[oid]),
            sym_trans=_st(oid))

    def e_mspd(est, gt):
        oid = gt["obj_id"]
        return mspd_np(
            np.asarray(est["R"]), np.asarray(est["t"]),
            np.asarray(gt["R"]), np.asarray(gt["t"]),
            np.asarray(models[oid]), np.asarray(sym_rots[oid]),
            np.asarray(gt["K"]), sym_trans=_st(oid))

    # attach diameters for normalized thresholds
    for gt_list in gts.values():
        for g in gt_list:
            g.setdefault("diameter", diameters[g["obj_id"]])

    mssd_thr = [t for t in np.arange(0.05, 0.51, 0.05)]
    mspd_thr = [float(t) * im_width / 640.0 for t in np.arange(5, 51, 5)]

    r_mssd = score_error_recalls(estimates, gts, targets, e_mssd, mssd_thr,
                                 normalize_by_diameter=True)
    r_mspd = score_error_recalls(estimates, gts, targets, e_mspd, mspd_thr)
    out = {"AR_mssd": r_mssd["AR"], "AR_mspd": r_mspd["AR"]}
    if with_vsd is not None:
        r_vsd = score_error_recalls(estimates, gts, targets, with_vsd,
                                    [t for t in np.arange(0.05, 0.51, 0.05)])
        out["AR_vsd"] = r_vsd["AR"]
        out["AR"] = (out["AR_vsd"] + out["AR_mssd"] + out["AR_mspd"]) / 3.0
    else:
        out["AR"] = (out["AR_mssd"] + out["AR_mspd"]) / 2.0
    return out
