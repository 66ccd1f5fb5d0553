"""Precompute FPS keypoints for every model of a dataset.

Counterpart of ``tools/compute_fps.py`` (the reference's
tools/<ds>/1_compute_fps.py): for each object, farthest-point keypoint
sets {4, 8, 12, 16, 20, 32, 64, 256} with the vertex mean appended,
written as ``<model_dir>/fps_points.pkl`` keyed by str(obj_id) ->
{"fps{n}_and_center": [n+1, 3]}, merged into an existing pickle. The
keypoints are ``data/assets.get_fps_and_center``'s, index-equal to the
JAX package's native FPS.

Usage: python -m rdpn6d_tpu_torch.tools.compute_fps --dataset ycbv \\
    [--counts 8 32] [--objs ...] [--out PATH] [--custom-root [NAME=]PATH]
"""

from __future__ import annotations

import argparse
import os
import pickle


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", required=True)
    p.add_argument("--counts", type=int, nargs="*",
                   default=[4, 8, 12, 16, 20, 32, 64, 256])
    p.add_argument("--out", default="")
    p.add_argument("--objs", nargs="*", default=[],
                   help="object names to process (default: all with a "
                        "model on disk; partial trees/subsets welcome)")
    p.add_argument("--custom-root", default="",
                   help="PATH or NAME=PATH: register --dataset as a custom "
                        "BOP-layout tree rooted there before resolving it "
                        "(data/custom.py); a NAME must match --dataset")
    args = p.parse_args(argv)

    from ..data.assets import get_fps_and_center
    from ..data.inout import load_ply
    from ..data.refs import get_ref

    if args.custom_root:
        from ..data.custom import register_custom_dataset

        croot = args.custom_root
        if "=" in croot:
            cname, _, croot = croot.partition("=")
            if cname != args.dataset:
                raise SystemExit(
                    f"--custom-root name '{cname}' does not match "
                    f"--dataset '{args.dataset}'")
        if not croot:
            raise SystemExit("--custom-root: empty path")
        register_custom_dataset(args.dataset, root=croot)
    ref = get_ref(args.dataset)
    out_path = args.out or os.path.join(ref.model_dir, "fps_points.pkl")
    obj_ids = [ref.obj2id[o] for o in args.objs] if args.objs \
        else [oid for oid in ref.obj_ids
              if os.path.exists(ref.model_path(oid))]
    if not obj_ids:
        raise SystemExit(f"no models found under {ref.model_dir}")
    # merge into an existing pickle: a --objs subset or partial-tree run
    # must not clobber keypoints computed earlier for other objects
    result = {}
    if os.path.exists(out_path):
        with open(out_path, "rb") as f:
            result = pickle.load(f)
        print(f"merging into existing {out_path} ({sorted(result)})")
    for oid in obj_ids:
        ply = load_ply(ref.model_path(oid), vertex_scale=ref.vertex_scale)
        pts = ply["pts"].astype("float32")
        result[str(oid)] = {f"fps{n}_and_center": get_fps_and_center(pts, n)
                            for n in args.counts}
        print(f"obj {oid}: {len(pts)} verts -> fps {args.counts}")
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
