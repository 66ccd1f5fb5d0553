"""Fuse detection JSON files into one, keeping the best-scored per
(scene, image, object).

Counterpart of ``tools/fuse_detections.py`` (the reference's per-dataset
fusion scripts, tools/lmo/1_gen_det_lm_real_all_fuse.py).

Usage: python -m rdpn6d_tpu_torch.tools.fuse_detections --out fused.json \\
    a.json b.json [--keep 1]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("inputs", nargs="+")
    p.add_argument("--out", required=True)
    p.add_argument("--keep", type=int, default=1,
                   help="detections kept per (scene,im,obj)")
    args = p.parse_args(argv)

    from ..data.detections import load_detections

    best: dict[tuple, list[dict]] = {}
    for path in args.inputs:
        for (scene, im), dets in load_detections(path).items():
            for d in dets:
                best.setdefault((scene, im, d["obj_id"]), []).append(d)

    out = []
    for (scene, im, obj), dets in sorted(best.items()):
        for d in sorted(dets, key=lambda x: -x["score"])[:args.keep]:
            x1, y1, x2, y2 = [float(v) for v in d["bbox"]]
            out.append({"scene_id": scene, "im_id": im, "obj_id": obj,
                        "bbox_est": [x1, y1, x2 - x1, y2 - y1],
                        "score": d["score"], "time": d["time"]})
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"wrote {len(out)} detections to {args.out}")


if __name__ == "__main__":
    main()
