"""Render a complete miniature BOP dataset with the port's rasterizer.

Counterpart of ``tools/make_mini_bop.py``, the full-protocol rehearsal
fixture: 3 LM objects (``data/synthetic.mini_meshes``: an irregular
tetrahedron "ape", asymmetric; a cube "can", whose 4-fold z symmetry
``models_info.json`` declares; an L-prism "driller", asymmetric) rendered
into the reserved lm scenes 91 (train) and 92 (test): frames of 2-3
objects clustered so that they occlude (z-buffer compositing),
scene_gt / scene_camera / scene_gt_info, models + models_eval, a BOP19
targets json and an est-detections json with jittered boxes and misses.
The draws are the JAX tool's, in its order, so one seed gives the same
scenes.

RGB carries signal correlated with model coordinates (NOCS-style albedo
and a Lambert-like shade by the depth gradient), so the coordinate head
has something to learn from. PNGs are written with ``data/png.py``.

Usage: python -m rdpn6d_tpu_torch.tools.make_mini_bop --out DIR \\
    [--n-train 60 --n-test 10 --seed 0]
Then ``python -m rdpn6d_tpu_torch.tools.rehearse_protocol`` drives the
compute_fps -> gen_xyz_crop -> train -> eval -> score_csv chain on it.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

TRAIN_SCENE, TEST_SCENE = 91, 92
OBJS = {1: "ape", 5: "can", 8: "driller"}
K_CAM = np.array([[572.4114, 0.0, 325.2611],
                  [0.0, 573.57043, 242.04899],
                  [0.0, 0.0, 1.0]], np.float64)
H, W = 480, 640


def models_info(meshes) -> dict:
    info = {}
    for oid, (v, _) in meshes.items():
        lo, hi = v.min(0), v.max(0)
        # exact max pairwise distance over the (subdivided) vertex set
        d2 = ((v[:, None, :] - v[None, :, :]) ** 2).sum(-1)
        entry = {
            "diameter": float(np.sqrt(d2.max())),
            "min_x": float(lo[0]), "min_y": float(lo[1]),
            "min_z": float(lo[2]),
            "size_x": float(hi[0] - lo[0]), "size_y": float(hi[1] - lo[1]),
            "size_z": float(hi[2] - lo[2]),
        }
        if oid == 5:  # cube: 4-fold z rotations (non-identity)
            syms = []
            for k in (1, 2, 3):
                a = np.pi / 2 * k
                Rz = np.array([[np.cos(a), -np.sin(a), 0],
                               [np.sin(a), np.cos(a), 0], [0, 0, 1]])
                T = np.eye(4)
                T[:3, :3] = Rz
                syms.append(T.reshape(-1).tolist())
            entry["symmetries_discrete"] = syms
        info[str(oid)] = entry
    return info


def render_scene_image(meshes_m, insts, rng):
    """insts: [(obj_id, R, t)] -> (rgb uint8, depth m, per-instance visible
    masks, per-instance full masks)."""
    from ..ops.rasterizer import render_mesh

    depths, xyzs = [], []
    for oid, R, t in insts:
        v, f = meshes_m[oid]
        d, x = render_mesh(v, f, K_CAM, R, t, H, W)
        depths.append(d)
        xyzs.append(x)
    depth = np.zeros((H, W), np.float32)
    owner = np.full((H, W), -1, np.int32)
    for i, d in enumerate(depths):
        m = (d > 0) & ((depth <= 0) | (d < depth))
        depth = np.where(m, d, depth)
        owner = np.where(m, i, owner)

    rgb = rng.randint(30, 70, (H, W, 3)).astype(np.float32)  # bg noise
    for i, ((oid, R, t), x) in enumerate(zip(insts, xyzs)):
        vis = owner == i
        v, _ = meshes_m[oid]
        ext = v.max(0) - v.min(0)
        albedo = (x / ext + 0.5) * 175.0 + 40.0        # NOCS-style colour
        # a cheap Lambert: shade by the depth gradient's magnitude
        shade = 1.0 - np.clip(np.abs(np.gradient(
            np.where(vis, depth, 0.0))[0]) * 200.0, 0.0, 0.5)
        rgb = np.where(vis[..., None], albedo * shade[..., None], rgb)
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    visib = [(owner == i) for i in range(len(insts))]
    full = [(d > 0) for d in depths]
    return rgb, depth, visib, full


def write_scene(root, subdir, scene_id, n_images, meshes_m, rng,
                targets=None, dets=None, miss_every=0):
    from ..data.png import write_png
    from ..data.synthetic import _random_rotation

    sdir = os.path.join(root, "lm", subdir, f"{scene_id:06d}")
    for sub in ("rgb", "depth", "mask_visib"):
        os.makedirs(os.path.join(sdir, sub), exist_ok=True)
    scene_gt, scene_cam, scene_info = {}, {}, {}
    obj_ids = sorted(meshes_m)
    n_rois = 0
    for im_id in range(n_images):
        n_obj = rng.randint(2, len(obj_ids) + 1)
        chosen = rng.choice(obj_ids, size=n_obj, replace=False)
        insts = []
        base_xy = rng.uniform(-0.06, 0.06, 2)
        for oid in chosen:
            R = _random_rotation(rng)
            # clustered around base_xy so that objects occlude each other
            t = np.array([base_xy[0] + rng.uniform(-0.07, 0.07),
                          base_xy[1] + rng.uniform(-0.06, 0.06),
                          rng.uniform(0.55, 0.85)])
            insts.append((int(oid), R, t))
        rgb, depth, visib, full = render_scene_image(meshes_m, insts, rng)

        gts, infos, keep = [], [], []
        for j, ((oid, R, t), mv, mf) in enumerate(zip(insts, visib, full)):
            # fully occluded GTs are kept (visib_fract ~0): the train visib
            # filter and the eval targets handle them, as in real BOP
            vf = float(mv.sum()) / max(float(mf.sum()), 1.0)
            ys, xs = np.nonzero(mv)
            if xs.size == 0:
                bbox = [0, 0, 0, 0]
            else:
                bbox = [int(xs.min()), int(ys.min()),
                        int(xs.max() - xs.min() + 1),
                        int(ys.max() - ys.min() + 1)]
            gts.append({"cam_R_m2c": R.reshape(-1).tolist(),
                        "cam_t_m2c": (t * 1000.0).tolist(),
                        "obj_id": int(oid)})
            infos.append({"bbox_visib": bbox, "visib_fract": vf})
            keep.append((oid, bbox, vf))
            write_png(os.path.join(sdir, "mask_visib",
                                   f"{im_id:06d}_{j:06d}.png"),
                      mv.astype(np.uint8) * 255)
        write_png(os.path.join(sdir, "rgb", f"{im_id:06d}.png"), rgb)
        write_png(os.path.join(sdir, "depth", f"{im_id:06d}.png"),
                  np.round(depth * 1000.0).astype(np.uint16))
        scene_gt[str(im_id)] = gts
        scene_cam[str(im_id)] = {"cam_K": K_CAM.reshape(-1).tolist(),
                                 "depth_scale": 1.0}
        scene_info[str(im_id)] = infos

        if targets is not None:
            counts: dict[int, int] = {}
            for oid, bbox, vf in keep:
                if vf > 0.05:
                    counts[oid] = counts.get(oid, 0) + 1
            for oid, cnt in sorted(counts.items()):
                targets.append({"im_id": im_id, "inst_count": cnt,
                                "obj_id": int(oid),
                                "scene_id": int(scene_id)})
        if dets is not None:
            for oid, bbox, vf in keep:
                n_rois += 1
                if vf <= 0.05:
                    continue        # an undetectable sliver
                if miss_every and n_rois % miss_every == 0:
                    continue        # a simulated detector miss
                x, y, w_, h_ = bbox
                jit = rng.randint(-3, 4, 4)
                dets.append({
                    "scene_id": int(scene_id), "im_id": im_id,
                    "obj_id": int(oid),
                    "bbox_est": [float(x + jit[0]), float(y + jit[1]),
                                 float(max(w_ + jit[2], 8)),
                                 float(max(h_ + jit[3], 8))],
                    "score": float(rng.uniform(0.5, 1.0)),
                    "time": 0.05,
                })

    for name, table in (("scene_gt.json", scene_gt),
                        ("scene_camera.json", scene_cam),
                        ("scene_gt_info.json", scene_info)):
        with open(os.path.join(sdir, name), "w") as f:
            json.dump(table, f)


def make(out: str, n_train: int = 60, n_test: int = 10,
         seed: int = 0) -> None:
    from ..data.synthetic import _write_points_ply, mini_meshes

    rng = np.random.RandomState(seed)
    meshes = mini_meshes()
    mdir = os.path.join(out, "lm", "models")
    mdir_eval = os.path.join(out, "lm", "models_eval")
    for oid, (v, f) in meshes.items():
        for d in (mdir, mdir_eval):
            _write_points_ply(os.path.join(d, f"obj_{oid:06d}.ply"), v, f)
    info = models_info(meshes)
    for d in (mdir, mdir_eval):
        with open(os.path.join(d, "models_info.json"), "w") as f:
            json.dump(info, f)

    meshes_m = {oid: (v / 1000.0, f) for oid, (v, f) in meshes.items()}
    write_scene(out, "train", TRAIN_SCENE, n_train, meshes_m, rng)
    targets: list = []
    dets: list = []
    write_scene(out, "test", TEST_SCENE, n_test, meshes_m, rng,
                targets=targets, dets=dets, miss_every=9)
    with open(os.path.join(out, "lm", "test_targets_mini.json"),
              "w") as f:
        json.dump(targets, f)
    with open(os.path.join(out, "lm", "detections_mini.json"), "w") as f:
        json.dump(dets, f)
    print(f"mini-BOP written to {out}: {n_train} train / {n_test} test "
          f"images, {len(dets)} detections, {len(targets)} targets")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--n-train", type=int, default=60)
    p.add_argument("--n-test", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    make(args.out, args.n_train, args.n_test, args.seed)


if __name__ == "__main__":
    main()
