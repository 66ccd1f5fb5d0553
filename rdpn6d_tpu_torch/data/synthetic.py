"""Synthetic fixtures in numpy: consistent fake train batches and an
analytic cube scene.

The port's own copy of ``rdpn6d_tpu/data/synthetic.py`` (which the port
cannot import): ``dummy_train_batch`` (a preprocessed batch with pose
targets consistent with the camera and box), ``render_cube_depth`` (a
point-splat depth / xyz render of a cube, no GL) and
``dummy_grouped_inputs`` (raw grouped train inputs, frames + per-ROI GT,
for ``preprocess_rois_grouped(train=True)``). Every array is numpy, so a
test can feed the same inputs to both packages. ``write_lm_tree`` writes a
LineMOD-layout BOP tree of rendered cubes to disk (PNGs through
``data/png.py``) with train and test lists and GT xyz crops, and
``write_lm_imgn_tree`` the lm_imgn synthetic layout beside it; either
package trains and evaluates on them. ``write_resnet_pth`` writes a seeded
ResNet ``state_dict`` with torchvision's keys, in place of the ImageNet
weights.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from ..config import Config
from .assets import cube_points, fps_numpy
from .png import write_png


def _np_ego_to_allo(R_ego: np.ndarray, t: np.ndarray) -> np.ndarray:
    v = t / np.linalg.norm(t)
    K = np.array([[0, 0, v[0]], [0, 0, v[1]], [-v[0], -v[1], 0]])
    corr = np.eye(3) + K + K @ K / (1.0 + v[2])
    return corr.T @ R_ego


def dummy_train_batch(cfg: Config, batch_size: int = 4,
                      seed: int = 0, num_points: int = 64
                      ) -> dict[str, np.ndarray]:
    """Random but geometrically consistent preprocessed train batch."""
    rng = np.random.RandomState(seed)
    b = batch_size
    res, out = cfg.backbone.input_res, cfg.head.out_res
    K_regions = cfg.head.num_regions

    cam = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                   np.float32)

    g = rng.randn(b, 3, 3)
    q, r = np.linalg.qr(g)
    q *= np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    det = np.linalg.det(q)
    q[:, :, 0] *= det[:, None]
    R_ego = q.astype(np.float32)

    t = np.stack([rng.uniform(-0.1, 0.1, b), rng.uniform(-0.1, 0.1, b),
                  rng.uniform(0.5, 1.2, b)], -1).astype(np.float32)

    proj = (cam @ t.T).T
    c2d = proj[:, :2] / proj[:, 2:3]
    bbox_center = (c2d + rng.uniform(-8, 8, (b, 2))).astype(np.float32)
    bw = rng.uniform(80, 160, b).astype(np.float32)
    scale = (bw * 1.5).astype(np.float32)
    resize_ratio = (out / scale).astype(np.float32)

    delta_c = c2d - bbox_center
    trans_ratio = np.stack([delta_c[:, 0] / bw, delta_c[:, 1] / bw,
                            t[:, 2] / resize_ratio], -1).astype(np.float32)

    R_allo = np.stack([_np_ego_to_allo(R_ego[i], t[i]) for i in range(b)])

    pts = cube_points()
    fps_idx = fps_numpy(pts, K_regions)
    fps = np.tile(pts[fps_idx][None], (b, 1, 1)).astype(np.float32)
    model_points = np.tile(
        pts[rng.choice(len(pts), num_points)][None], (b, 1, 1)
    ).astype(np.float32)

    mask = (rng.rand(b, out, out) > 0.5).astype(np.float32)

    batch = {
        "roi_img": rng.rand(b, res, res, 6).astype(np.float32),
        "roi_coord_2d": rng.rand(b, out, out, 5).astype(np.float32),
        "fps": fps,
        "roi_extent": np.tile(np.array([0.1, 0.1, 0.1], np.float32),
                              (b, 1)),
        "roi_cam": np.tile(cam[None], (b, 1, 1)),
        "bbox_center": bbox_center,
        "roi_wh": np.stack([bw, bw], -1),
        "resize_ratio": resize_ratio,
        "roi_xyz": rng.rand(b, out, out, 3).astype(np.float32),
        "roi_mask_trunc": mask,
        "roi_mask_visib": mask,
        "roi_mask_obj": mask,
        "roi_region": rng.randint(0, K_regions + 1,
                                  (b, out, out)).astype(np.int32),
        "gt_rot": R_ego,
        "gt_trans": t,
        "trans_ratio": trans_ratio,
        "roi_points": model_points,
        "sym_rots": np.tile(np.eye(3, dtype=np.float32), (b, 4, 1, 1)),
        "gt_allo_rot6d": np.concatenate(
            [R_allo[:, :, 0], R_allo[:, :, 1]], -1).astype(np.float32),
    }
    if cfg.head.xyz_loss == "CE_coor":
        batch["roi_xyz_bin"] = rng.randint(
            0, cfg.head.xyz_bin + 1, (b, out, out, 3)).astype(np.int32)
    return batch


def render_cube_depth(R: np.ndarray, t: np.ndarray, K: np.ndarray,
                      im_h: int, im_w: int, half: float = 0.05,
                      n_samples: int = 120) -> tuple[np.ndarray, np.ndarray]:
    """Point-splat render of a cube of side 2*half: (depth [H,W],
    model-frame xyz [H,W,3]), dense surface samples projected with a
    z-buffer (the nearest sample wins a pixel)."""
    g = np.linspace(-half, half, n_samples)
    a, bb = np.meshgrid(g, g)
    faces = []
    for fixed in (-half, half):
        for axis in range(3):
            face = np.stack([a.ravel(), bb.ravel(),
                             np.full(a.size, fixed)], -1)
            faces.append(np.roll(face, axis, axis=-1))
    mpts = np.concatenate(faces, 0)

    cpts = mpts @ R.T + t
    z = cpts[:, 2]
    uv = (K @ cpts.T).T
    u = np.round(uv[:, 0] / uv[:, 2]).astype(int)
    v = np.round(uv[:, 1] / uv[:, 2]).astype(int)
    ok = (u >= 0) & (u < im_w) & (v >= 0) & (v < im_h) & (z > 0)

    depth = np.zeros((im_h, im_w), np.float32)
    xyz = np.zeros((im_h, im_w, 3), np.float32)
    zbuf = np.full((im_h, im_w), np.inf, np.float32)
    uu, vv, zz, mm = u[ok], v[ok], z[ok], mpts[ok]
    order = np.argsort(-zz)  # far first; near overwrites
    for i in order:
        if zz[i] < zbuf[vv[i], uu[i]]:
            zbuf[vv[i], uu[i]] = zz[i]
            depth[vv[i], uu[i]] = zz[i]
            xyz[vv[i], uu[i]] = mm[i]
    return depth, xyz


def dummy_grouped_inputs(cfg: Config, n_frames: int = 2,
                         rois_per_frame: int = 2, seed: int = 0,
                         num_points: int = 64,
                         im_hw: tuple[int, int] = (120, 160),
                         ship_xyz: bool = False, focal: float = 140.0
                         ) -> tuple[dict[str, np.ndarray],
                                    dict[str, np.ndarray]]:
    """Raw grouped train inputs ``(frames, rois)``: per-frame cube scenes
    rendered analytically (a pinhole camera of ``focal`` px at the frame's
    center), per-ROI GT in compact dtypes (packed uint8 masks). Without
    ``ship_xyz`` the coords come from the depth surface on the device, as
    the JAX fixture's do; with it each ROI also carries its rendered
    model-frame xyz map [H,W,3] as float16."""
    rng = np.random.RandomState(seed)
    H, W = im_hw
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                 np.float32)
    pts = cube_points()
    fps_idx = fps_numpy(pts, cfg.head.num_regions)
    fps = pts[fps_idx].astype(np.float32)
    model_points = pts[rng.choice(len(pts), num_points)].astype(np.float32)
    extent = np.array([0.1, 0.1, 0.1], np.float32)

    frames: dict[str, list] = {"rgb": [], "depth": [], "K": []}
    keys = ["frame_idx", "bbox", "mask_packed", "gt_rot", "gt_trans", "fps",
            "extent", "centroid_2d", "roi_points", "sym_rots", "roi_cls", "K"]
    rois: dict[str, list] = {k: [] for k in keys + ["xyz"] * ship_xyz}
    for f in range(n_frames):
        depth_full = np.zeros((H, W), np.float32)
        insts = []
        for i in range(rois_per_frame):
            g = rng.randn(3, 3)
            q, r = np.linalg.qr(g)
            R = (q * np.sign(np.diag(r))[None, :]).astype(np.float32)
            if np.linalg.det(R) < 0:
                R[:, 0] *= -1
            t = np.array([-0.08 + 0.16 * i / max(rois_per_frame - 1, 1),
                          rng.uniform(-0.02, 0.02),
                          rng.uniform(0.55, 0.7)], np.float32)
            d, xyz = render_cube_depth(R, t, K, H, W)
            mask = d > 0
            if not mask.any():
                raise ValueError("cube rendered outside the dummy frame")
            depth_full = np.where(mask & ((depth_full == 0)
                                          | (d < depth_full)),
                                  d, depth_full)
            insts.append((R, t, mask, xyz))
        frames["rgb"].append(rng.randint(0, 255, (H, W, 3)).astype(
            np.uint8))
        frames["depth"].append(depth_full)
        frames["K"].append(K)
        for R, t, mask, xyz in insts:
            ys, xs = np.nonzero(mask)
            proj = K @ t
            rois["frame_idx"].append(np.int32(f))
            rois["bbox"].append(np.array(
                [xs.min(), ys.min(), xs.max(), ys.max()], np.float32))
            rois["mask_packed"].append(
                (mask.astype(np.uint8) | (mask.astype(np.uint8) << 1)))
            rois["gt_rot"].append(R)
            rois["gt_trans"].append(t)
            rois["fps"].append(fps)
            rois["extent"].append(extent)
            rois["centroid_2d"].append((proj[:2] / proj[2]).astype(
                np.float32))
            rois["roi_points"].append(model_points)
            rois["sym_rots"].append(np.tile(np.eye(3, dtype=np.float32),
                                            (4, 1, 1)))
            rois["roi_cls"].append(np.int32(0))
            rois["K"].append(K)
            if ship_xyz:
                rois["xyz"].append(xyz.astype(np.float16))
    return ({k: np.stack(v) for k, v in frames.items()},
            {k: np.stack(v) for k, v in rois.items()})


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(rvec))
    k = rvec / max(theta, 1e-12)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * Kx + (1 - np.cos(theta)) * Kx @ Kx


def _write_points_ply(path: str, pts_mm: np.ndarray) -> None:
    lines = ["ply", "format ascii 1.0", f"element vertex {len(pts_mm)}",
             "property float x", "property float y", "property float z",
             "end_header"] + [f"{x:.4f} {y:.4f} {z:.4f}" for x, y, z in pts_mm]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


LM_K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
                 [0.0, 0.0, 1.0]])


def _write_xyz_crop(path: str, xyz: np.ndarray) -> None:
    """The GT coordinate crop of a rendered xyz map, as the JAX package's
    ``tools/gen_xyz_crop.py`` stores it: float16 over the inclusive box
    of its nonzero pixels."""
    ys, xs = np.nonzero(np.any(xyz != 0, -1))
    x1, y1, x2, y2 = int(xs.min()), int(ys.min()), int(xs.max()), \
        int(ys.max())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"xyz_crop": xyz[y1:y2 + 1, x1:x2 + 1].astype(np.float16),
                     "xyxy": (x1, y1, x2, y2)}, f)


def _backdrop(rng: np.random.RandomState, H: int, W: int) -> np.ndarray:
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    phase = rng.uniform(0, 6.28, 3)
    return np.stack([127 + 90 * np.sin(xx / (37 + 11 * c) + yy / 53
                                       + phase[c]) for c in range(3)], -1)


def _shade(rng, obj, xyz, bg) -> np.ndarray:
    rgb = np.where(obj[..., None], 128 + 1000.0 * xyz, bg)
    return np.clip(rgb + rng.normal(0, 4, rgb.shape), 0, 255).astype(
        np.uint8)


def write_lm_tree(root: str, objs: dict[str, int], frames_per_obj: int,
                  seed: int = 0) -> None:
    """A LineMOD-layout BOP tree under ``root/lm``: for each object
    (``objs`` maps name -> LM obj id) a cube of its own seeded size as
    ``models/`` and ``models_eval/`` point meshes (mm) with
    ``models_info.json``, a scene ``test/<obj_id:06d>`` of
    ``frames_per_obj`` 480x640 RGB-D frames rendered with LineMOD's camera
    (rgb, depth in mm, mask_visib, the GT xyz crop
    ``xyz_crop/<im>_000000.pkl``, scene_gt / scene_camera /
    scene_gt_info), and ``image_set/<obj>_test.txt`` and
    ``<obj>_train.txt``, each listing every frame. The cube sits 0.7-1.0 m
    from the camera before a background plane at 1.3 m."""
    rng = np.random.RandomState(seed)
    H, W = 480, 640
    K = LM_K
    ds = os.path.join(root, "lm")
    info, info_eval = {}, {}
    for name, oid in objs.items():
        half = float(rng.uniform(0.03, 0.08))
        size = 2000.0 * half
        for sub, n_edge, table in (("models", 25, info),
                                   ("models_eval", 15, info_eval)):
            _write_points_ply(os.path.join(ds, sub, f"obj_{oid:06d}.ply"),
                              cube_points(n_edge, half) * 1000.0)
            table[str(oid)] = {
                "diameter": size * np.sqrt(3), "min_x": -size / 2,
                "min_y": -size / 2, "min_z": -size / 2, "size_x": size,
                "size_y": size, "size_z": size}
        sdir = os.path.join(ds, "test", f"{oid:06d}")
        scene_gt, scene_cam, scene_info = {}, {}, {}
        for im_id in range(frames_per_obj):
            R = _rodrigues(rng.randn(3) * 0.8)
            t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.07, 0.07),
                          rng.uniform(0.7, 1.0)])
            depth, xyz = render_cube_depth(R, t, K, H, W, half=half)
            obj = depth > 0
            write_png(os.path.join(sdir, "rgb", f"{im_id:06d}.png"),
                      _shade(rng, obj, xyz, _backdrop(rng, H, W)))
            _write_xyz_crop(os.path.join(sdir, "xyz_crop",
                                         f"{im_id:06d}_000000.pkl"), xyz)
            write_png(os.path.join(sdir, "depth", f"{im_id:06d}.png"),
                      np.round(np.where(obj, depth, 1.3) * 1000.0)
                      .astype(np.uint16))
            write_png(os.path.join(sdir, "mask_visib",
                                   f"{im_id:06d}_000000.png"),
                      obj.astype(np.uint8) * 255)
            ys, xs = np.nonzero(obj)
            box = [int(xs.min()), int(ys.min()), int(xs.max() - xs.min()),
                   int(ys.max() - ys.min())]
            scene_gt[str(im_id)] = [{"cam_R_m2c": R.reshape(-1).tolist(),
                                     "cam_t_m2c": (t * 1000.0).tolist(),
                                     "obj_id": oid}]
            scene_cam[str(im_id)] = {"cam_K": K.reshape(-1).tolist(),
                                     "depth_scale": 1.0}
            scene_info[str(im_id)] = [{"bbox_obj": box, "bbox_visib": box,
                                       "px_count_visib": int(obj.sum()),
                                       "visib_fract": 1.0}]
        for fname, data in (("scene_gt.json", scene_gt),
                            ("scene_camera.json", scene_cam),
                            ("scene_gt_info.json", scene_info)):
            with open(os.path.join(sdir, fname), "w") as f:
                json.dump(data, f)
        os.makedirs(os.path.join(ds, "image_set"), exist_ok=True)
        for part in ("test", "train"):
            with open(os.path.join(ds, "image_set", f"{name}_{part}.txt"),
                      "w") as f:
                f.write("".join(f"{i}\n" for i in range(frames_per_obj)))
    for sub, table in (("models", info), ("models_eval", info_eval)):
        with open(os.path.join(ds, sub, "models_info.json"), "w") as f:
            json.dump(table, f)


def write_lm_imgn_tree(root: str, objs: dict[str, int], frames_per_obj: int,
                       seed: int = 0, first_id: int = 1000) -> None:
    """The lm_imgn layout under ``root/lm_imgn``, beside a ``write_lm_tree``
    tree whose meshes it borrows (each cube's size is read back from
    ``root/lm/models/models_info.json``): for each object,
    ``imgn/<obj>/<id>-color.png`` (the cube over a synthetic backdrop),
    ``-depth.png`` (the cube's depth in mm, 0 elsewhere), ``-pose.txt`` (a
    header row, then [R | t] in metres), the GT xyz crop
    ``xyz_crop_imgn/<obj>/<id>-xyz.pkl`` and the index
    ``image_set/train_<obj>.txt`` of ``<obj>/<id>`` lines. Ids count from
    ``first_id``; the default keeps them apart from the LM tree's image
    ids, which the JAX package's grouped loader would otherwise take for
    the same frames (ROADMAP queue 3)."""
    rng = np.random.RandomState(seed)
    H, W = 480, 640
    with open(os.path.join(root, "lm", "models", "models_info.json")) as f:
        sizes = {int(k): v["size_x"] for k, v in json.load(f).items()}
    ds = os.path.join(root, "lm_imgn")
    os.makedirs(os.path.join(ds, "image_set"), exist_ok=True)
    for name, oid in objs.items():
        half = sizes[oid] / 2000.0
        ids = [f"{name}/{first_id + i:06d}" for i in range(frames_per_obj)]
        for im_id in ids:
            R = _rodrigues(rng.randn(3) * 0.8)
            t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.07, 0.07),
                          rng.uniform(0.7, 1.0)])
            depth, xyz = render_cube_depth(R, t, LM_K, H, W, half=half)
            obj = depth > 0
            base = os.path.join(ds, "imgn", im_id)
            write_png(base + "-color.png",
                      _shade(rng, obj, xyz, _backdrop(rng, H, W)))
            write_png(base + "-depth.png",
                      np.round(depth * 1000.0).astype(np.uint16))
            np.savetxt(base + "-pose.txt", np.hstack([R, t[:, None]]),
                       header=name, comments="")
            _write_xyz_crop(os.path.join(ds, "xyz_crop_imgn",
                                         im_id + "-xyz.pkl"), xyz)
        with open(os.path.join(ds, "image_set", f"train_{name}.txt"),
                  "w") as f:
            f.write("".join(f"{i}\n" for i in ids))


def write_resnet_pth(path: str, depth: int = 34, seed: int = 0) -> str:
    """A seeded ResNet ``state_dict`` with torchvision's keys (classifier
    and BatchNorm counters included), saved with ``torch.save``; returns
    ``path``. Stands in for the ImageNet weights, which are not on disk."""
    import torch

    from ..models.resnet import RESNET_SPECS

    rng = np.random.RandomState(seed)
    kind, layers = RESNET_SPECS[depth]
    sd: dict[str, np.ndarray] = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = (rng.randn(cout, cin, k, k)
                                * np.sqrt(2.0 / (cin * k * k)))

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c)
        sd[f"{name}.bias"] = rng.randn(c) * 0.1
        sd[f"{name}.running_mean"] = rng.randn(c) * 0.1
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c)
        sd[f"{name}.num_batches_tracked"] = np.array(1000, np.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    expansion = 1 if kind == "basic" else 4
    cin = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
        for i in range(n):
            pre = f"layer{stage + 1}.{i}"
            stride = 2 if (stage > 0 and i == 0) else 1
            if kind == "basic":
                convs = [(planes, cin, 3), (planes, planes, 3)]
            else:
                convs = [(planes, cin, 1), (planes, planes, 3),
                         (planes * 4, planes, 1)]
            for c, (co, ci, k) in enumerate(convs, start=1):
                conv(f"{pre}.conv{c}", co, ci, k)
                bn(f"{pre}.bn{c}", co)
            if stride != 1 or cin != planes * expansion:
                conv(f"{pre}.downsample.0", planes * expansion, cin, 1)
                bn(f"{pre}.downsample.1", planes * expansion)
            cin = planes * expansion
    sd["fc.weight"] = rng.randn(1000, cin) * 0.01
    sd["fc.bias"] = np.zeros(1000)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: torch.from_numpy(v if v.dtype == np.int64
                                    else v.astype(np.float32))
                for k, v in sd.items()}, path)
    return path
