"""External-detector boxes for estimated-box evaluation.

The port's own copy of ``rdpn6d_tpu/data/detections.py``: read a
detections JSON (a list of {scene_id/im_id or scene_im_id, obj_id,
bbox_est [x,y,w,h], score, time}, or a {"scene/im": [...]} mapping), keep
the top-k per object and image, and attach each to the GT instance it
overlaps most.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any

import numpy as np


def load_detections(path: str) -> dict[tuple[int, int], list[dict]]:
    """-> {(scene_id, im_id): [det, ...]} with xyxy float bboxes."""
    with open(path) as f:
        raw = json.load(f)
    if isinstance(raw, dict):
        # {scene_im_id: [dets]} layout
        items = []
        for key, dets in raw.items():
            s, i = key.split("/")
            for d in dets:
                d = dict(d)
                d.setdefault("scene_id", int(s))
                d.setdefault("im_id", int(i))
                items.append(d)
        raw = items
    out: dict[tuple[int, int], list[dict]] = defaultdict(list)
    for d in raw:
        if "scene_id" not in d and "scene_im_id" in d:
            # list layout with BOP-style "scene/id" keys per entry
            d = dict(d)
            s, i = str(d["scene_im_id"]).split("/")
            d["scene_id"], d["im_id"] = int(s), int(i)
        if "bbox_est" not in d and "bbox" not in d:
            raise ValueError(
                f"detection entry without bbox_est/bbox: {sorted(d)} "
                f"(scene {d.get('scene_id')}, im {d.get('im_id')})")
        bbox = np.asarray(d.get("bbox_est", d.get("bbox")), np.float32)
        # detections are xywh (BOP det convention); convert to xyxy
        xyxy = np.array([bbox[0], bbox[1], bbox[0] + bbox[2],
                         bbox[1] + bbox[3]], np.float32)
        out[(int(d["scene_id"]), int(d["im_id"]))].append({
            "obj_id": int(d["obj_id"]),
            "bbox": xyxy,
            "score": float(d.get("score", 1.0)),
            "time": float(d.get("time", -1.0)),
        })
    return out


def attach_detections(records: list[dict[str, Any]],
                      detections: dict[tuple[int, int], list[dict]],
                      topk_per_obj: int = 1,
                      score_thr: float = 0.0) -> list[dict[str, Any]]:
    """Replace each test record's GT bbox with its matched detection bbox.

    Records without a detection for their object are dropped (the reference
    logs and skips, dataset_utils.py:117-186). Detections are assigned to
    DISTINCT GT records of the same (scene, im, obj) greedily by bbox IoU
    in descending score order — one prediction row per detection, never one
    per (detection x GT instance), and on duplicate-instance images each
    detection lands on the GT instance it actually overlaps (so the classic
    per-instance metrics score against the right R_gt/t_gt; the BOP19
    scorer re-matches and is insensitive to this).
    """
    by_key: dict[tuple[int, int, int], list[dict]] = defaultdict(list)
    for rec in records:
        by_key[(rec["scene_id"], rec["im_id"], rec["obj_id"])].append(rec)

    def _gt_xyxy(rec) -> np.ndarray:
        b = rec.get("bbox_visib")
        if b is None:  # no GT bbox: IoU 0 -> falls back to score order
            return np.zeros(4, np.float32)
        b = np.asarray(b, np.float32)
        if rec.get("bbox_mode", "xywh") == "xywh":
            b = np.array([b[0], b[1], b[0] + b[2], b[1] + b[3]], np.float32)
        return b

    def _iou(a: np.ndarray, b: np.ndarray) -> float:
        ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = ix * iy
        ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
        return float(inter / max(ua - inter, 1e-9))

    out = []
    for (scene_id, im_id, obj_id), recs in by_key.items():
        dets = detections.get((scene_id, im_id), [])
        cands = sorted(
            (d for d in dets
             if d["obj_id"] == obj_id and d["score"] >= score_thr),
            key=lambda d: -d["score"])[:topk_per_obj]
        gt_boxes = [_gt_xyxy(r) for r in recs]
        free = list(range(len(recs)))
        for d in cands:
            if not free:
                break
            best = max(free, key=lambda i: _iou(d["bbox"], gt_boxes[i]))
            free.remove(best)
            r = dict(recs[best])
            r["bbox_visib"] = d["bbox"]
            r["bbox_mode"] = "xyxy"  # det bboxes are already converted
            r["det_score"] = d["score"]
            r["det_time"] = d["time"]
            out.append(r)
    return out
