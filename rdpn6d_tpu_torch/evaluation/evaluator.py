"""Pose evaluator: accumulate per-instance predictions, score ADD(-S)/AUC/
re/te/proj per object, emit tables and BOP19 CSV rows.

Counterpart of ``rdpn6d_tpu/evaluation/evaluator.py``. Predictions are
kept as whole-batch numpy chunks; the errors of each object are computed
in one batch on the evaluator's device (``cuda`` unless the caller names
one), ADI through ``pose_error.adi`` and so the ``min_dist2`` kernel, one
launch per object with predictions. Recalls and AUCs are host numpy.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..geometry import closest_rot
from ..utils.device import resolve_device
from .pose_error import add, adi, proj_2d, re_deg, te
from .score import auc_posecnn, auc_voc, pose_recalls, summarize_objects

logger = logging.getLogger("rdpn6d")

_ERROR_KEYS = ("ad", "add", "adi", "re", "te", "proj")


@dataclass
class PoseEvaluator:
    """Accumulates (R, t) estimates against GT and scores per object.

    models: {obj_name: [N,3] eval model points (m)}; diameters: {obj_name:
    diameter (m)}; sym_rots: {obj_name: [S,3,3] identity-padded bank or
    None}. n_gts: {obj_name: GT instances in the split}; with it, recall
    denominators are GT counts and missing predictions count as failures
    (padded with +inf), unless ``precision``. device: where the errors are
    computed.
    """

    models: dict[str, np.ndarray]
    diameters: dict[str, float]
    sym_rots: dict[str, np.ndarray | None] = field(default_factory=dict)
    n_gts: dict[str, int] | None = None
    precision: bool = False
    device: str | torch.device | None = None
    _chunks: list[dict[str, np.ndarray]] = field(default_factory=list)
    # compute_errors' result, keyed by the number of chunks it saw
    _err_cache: tuple[int, dict] | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def reset(self) -> None:
        self._chunks = []
        self._err_cache = None

    def process(self, obj_name: str, R_est, t_est, R_gt, t_gt, K,
                scene_id: int = 0, im_id: int = 0, score: float = 1.0,
                time: float = -1.0) -> None:
        """Single-instance form of ``process_batch``."""
        self.process_batch(
            [obj_name], np.asarray(R_est)[None], np.asarray(t_est)[None],
            np.asarray(R_gt)[None], np.asarray(t_gt)[None],
            np.asarray(K)[None], scene_ids=np.array([scene_id]),
            im_ids=np.array([im_id]), scores=np.array([score]),
            times=np.array([time]))

    def process_batch(self, obj_names: list[str], R_est, t_est, R_gt, t_gt,
                      K, scene_ids=None, im_ids=None, scores=None,
                      times=None) -> None:
        """Append one whole batch of predictions (arrays, leading dim B)."""
        B = len(obj_names)
        self._chunks.append({
            "obj": np.asarray(obj_names, dtype=object),
            "R": np.asarray(R_est, np.float32),
            "t": np.asarray(t_est, np.float32),
            "R_gt": np.asarray(R_gt, np.float32),
            "t_gt": np.asarray(t_gt, np.float32),
            "K": np.asarray(K, np.float32),
            "scene_id": np.zeros(B, np.int64) if scene_ids is None
            else np.asarray(scene_ids, np.int64),
            "im_id": np.zeros(B, np.int64) if im_ids is None
            else np.asarray(im_ids, np.int64),
            "score": np.ones(B, np.float32) if scores is None
            else np.asarray(scores, np.float32),
            "time": np.full(B, -1.0, np.float32) if times is None
            else np.asarray(times, np.float32),
        })

    def merge_chunks(self, chunks: list[dict[str, np.ndarray]]) -> None:
        """Fold in prediction chunks of other ranks
        (``parallel.gather_predictions``)."""
        self._chunks.extend(chunks)

    @property
    def chunks(self) -> list[dict[str, np.ndarray]]:
        return self._chunks

    def _consolidated(self) -> dict[str, np.ndarray] | None:
        if not self._chunks:
            return None
        return {k: np.concatenate([c[k] for c in self._chunks])
                for k in self._chunks[0]}

    def _object_errors(self, obj: str, p: dict[str, np.ndarray]
                       ) -> dict[str, np.ndarray]:
        dev = self.device

        def on(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        R_est, t_est, R_gt, t_gt, K = (on(p[k]) for k in
                                       ("R", "t", "R_gt", "t_gt", "K"))
        pts = on(np.asarray(self.models[obj], np.float32))[None]
        sym = self.sym_rots.get(obj)
        # identity-padded banks make every bank the same length: an object
        # is symmetric only if some entry is not the identity
        is_sym = sym is not None and len(sym) > 1 and bool(
            np.any(np.abs(np.asarray(sym) - np.eye(3)) > 1e-5))
        add_err = add(R_est, t_est, R_gt, t_gt, pts)
        adi_err = adi(R_est, t_est, R_gt, t_gt, pts)
        if is_sym:
            bank = on(np.asarray(sym, np.float32))[None].expand(
                R_est.shape[0], -1, -1, -1)
            R_gt_closest = closest_rot(R_est, R_gt, bank)
        else:
            R_gt_closest = R_gt
        err = {
            "ad": adi_err if is_sym else add_err,
            "add": add_err,
            "adi": adi_err,
            "re": re_deg(R_est, R_gt_closest),
            "te": te(t_est, t_gt),
            "proj": proj_2d(R_est, t_est, R_gt_closest, t_gt, pts, K),
        }
        return {k: v.cpu().numpy() for k, v in err.items()}

    def compute_errors(self) -> dict[str, dict[str, np.ndarray]]:
        """Per-object error arrays {obj: {ad, add, adi, re, te, proj}},
        over the union of predicted and GT objects in ``models`` order."""
        if self._err_cache is not None \
                and self._err_cache[0] == len(self._chunks):
            return self._err_cache[1]
        allp = self._consolidated()
        if allp is None and not self.n_gts:
            return {}
        # an object whose predictions are all missing still gets its
        # inf-padded failure rows, or the MEAN would skip it
        pred_objs = set(allp["obj"].tolist()) if allp is not None else set()
        objs = pred_objs | (set(self.n_gts) if self.n_gts else set())
        order = {o: i for i, o in enumerate(self.models)}
        unknown = sorted(o for o in objs if o not in order)
        if unknown:
            logger.warning(f"objects without eval models (skipping "
                           f"error computation for them): {unknown}")
        out = {}
        for obj in sorted(objs & set(order), key=order.__getitem__):
            m = (allp["obj"] == obj) if allp is not None \
                else np.zeros(0, bool)
            n_pred = int(m.sum())
            if n_pred > 0:
                err = self._object_errors(
                    obj, {k: v[m] for k, v in allp.items() if k != "obj"})
            else:
                err = {k: np.zeros(0, np.float32) for k in _ERROR_KEYS}
            if self.n_gts is not None and not self.precision:
                n_missing = self.n_gts.get(obj, 0) - n_pred
                if n_missing > 0:
                    err = {k: np.concatenate(
                        [v, np.full(n_missing, np.inf, v.dtype)])
                        for k, v in err.items()}
            if err["ad"].size > 0:
                out[obj] = err
        self._err_cache = (len(self._chunks), out)
        return out

    def evaluate(self) -> dict[str, Any]:
        """Per-object recalls and AUCs, and their MEAN row."""
        per_obj = {}
        for obj, err in self.compute_errors().items():
            d = self.diameters[obj]
            rec = pose_recalls(err["ad"], err["re"], err["te"], err["proj"],
                               d)
            rec["adi_10"] = float(np.mean(err["adi"] < d * 0.1) * 100.0)
            rec["AUCad"] = auc_posecnn(err["ad"])
            rec["AUCadd"] = auc_posecnn(err["add"])
            rec["AUCadi"] = auc_posecnn(err["adi"])
            rec["AUCad_voc"] = auc_voc(err["ad"] * 100.0)
            rec["ABSad_2cm"] = float(np.mean(err["ad"] < 0.02) * 100.0)
            per_obj[obj] = rec
        return {"per_obj": per_obj, "mean": summarize_objects(per_obj)}

    def bop_rows(self, obj2id: dict[str, int]) -> list[dict]:
        """Rows for ``inout.save_bop_results_csv``. The BOP toolkit wants
        ONE time per (scene, image): rows of an image that spanned two
        batches take the image's largest time."""
        allp = self._consolidated()
        if allp is None:
            return []
        keys = list(zip(allp["scene_id"].tolist(), allp["im_id"].tolist()))
        im_time: dict[tuple[int, int], float] = {}
        for k, tm in zip(keys, allp["time"].tolist()):
            im_time[k] = max(im_time.get(k, -1.0), tm)
        return [{
            "scene_id": k[0], "im_id": k[1],
            "obj_id": obj2id[allp["obj"][i]],
            "score": float(allp["score"][i]),
            "R": allp["R"][i], "t": allp["t"][i],
            "time": im_time[k],
        } for i, k in enumerate(keys)]


def format_table(result: dict[str, Any], metrics=("ad_2", "ad_5", "ad_10",
                                                  "AUCad", "re_2", "te_2",
                                                  "proj_2")) -> str:
    """Plain-text per-object metric table with the MEAN row."""
    lines = ["obj        " + " ".join(f"{m:>8}" for m in metrics)]
    for obj, rec in result["per_obj"].items():
        lines.append(f"{obj:<10} "
                     + " ".join(f"{rec[m]:8.2f}" for m in metrics))
    if result["mean"]:
        lines.append(f"{'MEAN':<10} "
                     + " ".join(f"{result['mean'][m]:8.2f}"
                                for m in metrics))
    return "\n".join(lines)
