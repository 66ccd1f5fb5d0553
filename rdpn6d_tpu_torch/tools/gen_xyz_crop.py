"""Generate the GT NOCS-style xyz crops of a dataset split.

Counterpart of ``tools/gen_xyz_crop.py`` (the reference's per-dataset
``tools/<ds>/*_gen_xyz_crop.py``): render each GT pose with the port's
host rasterizer (``ops/rasterizer.render_mesh``), crop the model-coordinate
map to its box and save it as float16 to the record's ``xyz_path``
(``xyz_crop/{im_id:06d}_{inst_idx:06d}.pkl``, {xyz_crop, xyxy}), the
pickles the train path's ``gt_labels`` reads.

Usage: python -m rdpn6d_tpu_torch.tools.gen_xyz_crop --split lm_13_train \\
    [--overwrite] [--custom-root NAME=PATH]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--split", required=True)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--custom-root", default="",
                   help="NAME=PATH: register a custom BOP-layout dataset "
                        "(and its {NAME}_train/{NAME}_test splits) before "
                        "resolving --split (data/custom.py)")
    args = p.parse_args(argv)

    from ..data.bop import build_split_records, get_split
    from ..data.inout import load_ply
    from ..data.refs import get_ref
    from ..ops.rasterizer import render_mesh

    if args.custom_root:
        from ..data.custom import register_custom_dataset

        cname, sep, croot = args.custom_root.partition("=")
        if not (sep and cname and croot):
            raise SystemExit(
                f"--custom-root expects NAME=PATH, got {args.custom_root!r}")
        register_custom_dataset(cname, root=croot)
    split = get_split(args.split)
    ref = get_ref(split.ref_name)
    records = build_split_records(split, flatten=True)

    meshes = {}
    n_done = 0
    for rec in records:
        out_path = rec["xyz_path"]
        if os.path.exists(out_path) and not args.overwrite:
            continue
        oid = rec["obj_id"]
        if oid not in meshes:
            ply = load_ply(ref.model_path(oid),
                           vertex_scale=ref.vertex_scale)
            if "faces" not in ply:
                raise RuntimeError(f"model {oid} has no faces")
            meshes[oid] = (ply["pts"].astype(np.float32),
                           ply["faces"].astype(np.int32))
        verts, faces = meshes[oid]
        depth, xyz = render_mesh(verts, faces, rec["K"], rec["R"], rec["t"],
                                 rec["height"], rec["width"])
        mask = depth > 0
        if not mask.any():
            continue
        ys, xs = np.nonzero(mask)
        x1, y1, x2, y2 = xs.min(), ys.min(), xs.max(), ys.max()
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "wb") as f:
            pickle.dump({
                "xyz_crop": xyz[y1:y2 + 1, x1:x2 + 1].astype(np.float16),
                "xyxy": (int(x1), int(y1), int(x2), int(y2)),
            }, f)
        n_done += 1
        if n_done % 200 == 0:
            print(f"{n_done} crops written")
    print(f"done: {n_done} crops")
    return n_done


if __name__ == "__main__":
    main()
