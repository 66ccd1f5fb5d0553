"""BOP19 scoring at full-split scale: the scoring half of a split's cost.

Counterpart of ``tools/bench_score_scale.py``. Draws a YCB-V-sized
estimate set in the JAX tool's order — ``--frames`` images x ``--objs``
objects (default 1000 x 5 = 5000 targets), ``--ests-per-target``
estimates a target with jittered poses (rotations by Rodrigues,
``data/synthetic._rodrigues``) — and times the in-process BOP19 pipeline
on the host (``evaluation/bop_score.bop19_average_recalls``: per-target
MSSD/MSPD error matrices, the greedy matcher over the threshold grid, the
AR reduction), then ``PoseEvaluator``'s recall tables over the best
estimate of each target, their errors on ``--device`` (ADI through the
``min_dist2`` kernel on a card, a launch an object). No image is needed.

Prints one JSON line with the JAX tool's keys: wall seconds a stage
(host clock, not rounded; the recall tables end in host numpy, so they
include the device's work), the ARs and ``mean_ad_10``.

Usage: python -m rdpn6d_tpu_torch.tools.bench_score_scale [--frames 1000]
    [--objs 5] [--pts 500] [--ests-per-target 4] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def estimate_set(frames: int, objs: int, pts: int, ests_per_target: int):
    """(models, gts, targets, estimates, K), drawn from ``RandomState(0)``
    in the JAX tool's order."""
    from ..data.synthetic import _rodrigues

    def rot(rng, scale=1.0):
        return _rodrigues(rng.randn(3) * scale)

    rng = np.random.RandomState(0)
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1.0]])
    models = {o: rng.randn(pts, 3).astype(np.float64) * 0.04
              for o in range(1, objs + 1)}
    gts: dict[tuple[int, int], list[dict]] = {}
    targets, estimates = [], []
    for im in range(frames):
        gts[(1, im)] = []
        for o in models:
            R = rot(rng)
            t = np.array([rng.uniform(-0.1, 0.1),
                          rng.uniform(-0.1, 0.1), 1.0])
            gts[(1, im)].append({"obj_id": o, "R": R, "t": t, "K": K})
            targets.append({"scene_id": 1, "im_id": im, "obj_id": o,
                            "inst_count": 1})
            for e in range(ests_per_target):
                dR = rot(rng, 0.02 * (e + 1))
                estimates.append({
                    "scene_id": 1, "im_id": im, "obj_id": o,
                    "score": 1.0 - 0.1 * e, "R": dR @ R,
                    "t": t + rng.randn(3) * 0.002 * (e + 1)})
    return models, gts, targets, estimates, K


def run(args) -> dict:
    """Time both stages; print and return the JSON line's dict."""
    from ..evaluation.evaluator import PoseEvaluator
    from ..evaluation.bop_score import bop19_average_recalls
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    models, gts, targets, estimates, K = estimate_set(
        args.frames, args.objs, args.pts, args.ests_per_target)
    diameters = {o: 0.15 for o in models}
    sym_rots = {o: np.eye(3)[None] for o in models}

    t0 = time.perf_counter()
    ars = bop19_average_recalls(estimates, gts, targets, models, sym_rots,
                                diameters)
    t_bop = time.perf_counter() - t0

    ev = PoseEvaluator(
        models={f"obj{o}": m.astype(np.float32) for o, m in models.items()},
        diameters={f"obj{o}": d for o, d in diameters.items()},
        n_gts={f"obj{o}": args.frames for o in models}, device=device)
    best = [e for e in estimates if e["score"] == 1.0]
    gt_of = {(e["scene_id"], e["im_id"], e["obj_id"]):
             next(g for g in gts[(e["scene_id"], e["im_id"])]
                  if g["obj_id"] == e["obj_id"]) for e in best}
    chunk = 4096
    t0 = time.perf_counter()
    for i in range(0, len(best), chunk):
        ch = best[i:i + chunk]
        gt = [gt_of[(e["scene_id"], e["im_id"], e["obj_id"])] for e in ch]
        ev.process_batch(
            [f"obj{e['obj_id']}" for e in ch],
            np.stack([e["R"] for e in ch]), np.stack([e["t"] for e in ch]),
            np.stack([g["R"] for g in gt]), np.stack([g["t"] for g in gt]),
            np.tile(K[None], (len(ch), 1, 1)),
            scene_ids=np.asarray([e["scene_id"] for e in ch]),
            im_ids=np.asarray([e["im_id"] for e in ch]))
    tables = ev.evaluate()
    t_tables = time.perf_counter() - t0

    line = {
        "frames": args.frames, "targets": len(targets),
        "estimates": len(estimates),
        "bop19_s": t_bop, "ars": ars,
        "recall_tables_s": t_tables,
        "mean_ad_10": tables["mean"].get("ad_10"),
    }
    print(json.dumps(line), flush=True)
    return line


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=1000)
    p.add_argument("--objs", type=int, default=5)
    p.add_argument("--pts", type=int, default=500,
                   help="eval-model points per object (BOP models_eval "
                        "meshes are ~1-4k verts; 500 is conservative-fast)")
    p.add_argument("--ests-per-target", type=int, default=4)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
