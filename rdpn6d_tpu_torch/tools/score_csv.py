"""Score an existing BOP19 result CSV against a split's GT (no model run).

Counterpart of ``tools/score_csv.py`` (the reference's cached-result path,
``eval_cached_results``, test_utils.py:78-135): re-score a results file
with the ADD(-S)/AUC metrics, the errors on ``--device`` (ADI through the
``min_dist2`` kernel on a card, one launch an object), and optionally the
BOP19 AR (MSSD/MSPD) on the host.

Usage: python -m rdpn6d_tpu_torch.tools.score_csv --csv result.csv \\
    --split ycbv_test [--bop19] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--csv", required=True)
    p.add_argument("--split", required=True)
    p.add_argument("--num-regions", type=int, default=32)
    p.add_argument("--bop19", action="store_true",
                   help="also compute BOP19 AR (MSSD/MSPD)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from ..data.assets import load_class_assets
    from ..data.bop import build_split_records, get_split
    from ..data.inout import load_bop_results_csv
    from ..data.refs import get_ref
    from ..evaluation.evaluator import PoseEvaluator, format_table
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    split = get_split(args.split)
    ref = get_ref(split.ref_name)
    records = build_split_records(split, flatten=True)
    results = load_bop_results_csv(args.csv)
    present = sorted({rec["obj_id"] for rec in records})
    # decimated eval meshes: what run_eval and the reference score on
    assets = load_class_assets(ref, args.num_regions,
                               objs=[ref.id2obj[oid] for oid in present],
                               use_eval_models=True)

    # GT by (scene, im, obj)
    gt_idx: dict[tuple, list[dict]] = {}
    n_gts: dict[str, int] = {}
    for rec in records:
        gt_idx.setdefault(
            (rec["scene_id"], rec["im_id"], rec["obj_id"]), []).append(rec)
        name = ref.id2obj[rec["obj_id"]]
        n_gts[name] = n_gts.get(name, 0) + 1

    def diameter(oid):
        return float(assets.for_obj(oid)["diameter"]) or ref.diameter_m(oid)

    ev = PoseEvaluator(
        models={ref.id2obj[oid]: assets.for_obj(oid)["points"]
                for oid in assets.obj_ids},
        diameters={ref.id2obj[oid]: diameter(oid) for oid in assets.obj_ids},
        sym_rots={ref.id2obj[oid]: assets.for_obj(oid)["sym_rots"]
                  for oid in assets.obj_ids},
        n_gts=n_gts,  # missing estimates count as failures, like run_eval
        device=device,
    )
    # estimates of one (scene, im, obj) pair to DISTINCT GT instances by
    # descending score: each takes the nearest (by translation) unmatched
    # GT, so duplicate-instance images are scored per instance
    by_key: dict[tuple, list[dict]] = {}
    for res in results:
        by_key.setdefault(
            (res["scene_id"], res["im_id"], res["obj_id"]), []).append(res)
    n_matched = 0
    for key, ests in by_key.items():
        if key not in gt_idx:
            continue
        gt_pool = list(gt_idx[key])
        for res in sorted(ests, key=lambda r: -r.get("score", 1.0)):
            if not gt_pool:
                break
            d = [np.linalg.norm(np.asarray(res["t"]) - g["t"])
                 for g in gt_pool]
            gt = gt_pool.pop(int(np.argmin(d)))
            ev.process(ref.id2obj[res["obj_id"]], res["R"], res["t"],
                       gt["R"], gt["t"], gt["K"], scene_id=res["scene_id"],
                       im_id=res["im_id"], score=res["score"])
            n_matched += 1
    logging.info(f"matched {n_matched}/{len(results)} estimates to GT")
    out = ev.evaluate()
    print(format_table(out))

    if args.bop19:
        from ..evaluation.bop_score import bop19_average_recalls

        gts: dict[tuple, list[dict]] = {}
        for rec in records:
            gts.setdefault((rec["scene_id"], rec["im_id"]), []).append(
                {"obj_id": rec["obj_id"], "R": rec["R"], "t": rec["t"],
                 "K": rec["K"]})
        targets = [{"scene_id": s, "im_id": i, "obj_id": o,
                    "inst_count": len(v)}
                   for (s, i, o), v in gt_idx.items()]
        ar = bop19_average_recalls(
            results, gts, targets,
            models={oid: assets.for_obj(oid)["points"]
                    for oid in assets.obj_ids},
            sym_rots={oid: assets.for_obj(oid)["sym_rots"]
                      for oid in assets.obj_ids},
            # full 4x4 symmetries: the translation part places off-origin
            # symmetry centres, as run_eval scores them
            sym_trans={oid: assets.for_obj(oid)["sym_trans"]
                       for oid in assets.obj_ids},
            diameters={oid: diameter(oid) for oid in assets.obj_ids},
            im_width=ref.width)
        print("BOP19:", {k: round(v, 4) for k, v in ar.items()})
    return out


if __name__ == "__main__":
    main()
