"""Synthetic fixtures in numpy: consistent fake train batches and an
analytic cube scene.

The port's own copy of ``rdpn6d_tpu/data/synthetic.py`` (which the port
cannot import): ``dummy_batch`` (the zero eval batch of the JAX
package's ``models.dummy_batch``), ``dummy_train_batch`` (a preprocessed
batch with pose targets consistent with the camera and box),
``render_cube_depth`` (a point-splat depth / xyz render of a cube, no GL)
and ``dummy_grouped_inputs`` (raw grouped train inputs, frames + per-ROI
GT, for ``preprocess_rois_grouped(train=True)``). Every array is numpy, so a
test can feed the same inputs to both packages. ``write_lm_tree`` writes a
LineMOD-layout BOP tree of rendered cubes to disk (PNGs through
``data/png.py``) with train and test lists and GT xyz crops, and
``write_lm_imgn_tree`` the lm_imgn synthetic layout beside it; either
package trains and evaluates on them. ``write_lmo_tree`` writes a
LineMOD-Occluded tree (real frames of occluding cubes with GT xyz crops,
BOP-PBR frames as JPEG without crops, a test scene with BOP19 targets),
``write_bop_tree`` the same for ycbv, tless, tudl, hb, icbin or itodd
(gray TIFF val frames at 960x1280) at the dataset's frame size, camera
and split directories (cubes rendered with the port's rasterizer, eval
meshes with faces, a symmetric object, some instances under 20% visible,
ycbv's keyframe list), ``write_mp6d_tree`` MP6D's ``ycb_style`` layout
(``-meta.mat`` through ``scipy.io.savemat``), ``write_blender_tree``
LineMOD's Blender renders beside a ``write_lm_tree`` tree,
``write_mini_tree``
the mini rehearsal dataset (LM scenes 91 and 92) and ``write_bg_pool`` a
VOC-like background pool of JPEG and PNG files.
``encode_jpeg`` / ``write_jpeg`` are a baseline JPEG encoder with the
standard tables, for these fixtures: the card's machine has no other JPEG
writer. ``write_resnet_pth`` writes a seeded ResNet ``state_dict`` with
torchvision's keys, in place of the ImageNet weights.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from ..config import Config
from .assets import cube_points, fps_numpy
from .png import write_png
from .tif import write_tif


def _np_ego_to_allo(R_ego: np.ndarray, t: np.ndarray) -> np.ndarray:
    v = t / np.linalg.norm(t)
    K = np.array([[0, 0, v[0]], [0, 0, v[1]], [-v[0], -v[1], 0]])
    corr = np.eye(3) + K + K @ K / (1.0 + v[2])
    return corr.T @ R_ego


def dummy_batch(cfg: Config, batch_size: int = 2) -> dict[str, np.ndarray]:
    """Minimal correctly-shaped eval batch (zero images), the JAX
    package's ``models.dummy_batch``."""
    res, out = cfg.backbone.input_res, cfg.head.out_res
    b = batch_size
    cam = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1.0]],
                   np.float32)
    return {
        "roi_cls": np.zeros((b,), np.int32),
        "roi_img": np.zeros((b, res, res, 6), np.float32),
        "roi_coord_2d": np.zeros((b, out, out, 5), np.float32),
        "fps": np.zeros((b, cfg.head.num_regions, 3), np.float32),
        "roi_extent": np.ones((b, 3), np.float32),
        "roi_cam": np.tile(cam[None], (b, 1, 1)),
        "bbox_center": np.full((b, 2), 128.0, np.float32),
        "roi_wh": np.full((b, 2), 128.0, np.float32),
        "resize_ratio": np.full((b,), out / 128.0, np.float32),
    }


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
    z-buffer (the nearest sample wins a pixel; of samples at one depth,
    the first), as one sort."""
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
    pix, zz, mm = v[ok] * im_w + u[ok], z[ok], mpts[ok]
    order = np.lexsort((zz, pix))               # by pixel, then nearest
    pix, zz, mm = pix[order], zz[order], mm[order]
    first = np.r_[True, pix[1:] != pix[:-1]]
    depth = np.zeros(im_h * im_w, np.float32)
    xyz = np.zeros((im_h * im_w, 3), np.float32)
    depth[pix[first]] = zz[first]
    xyz[pix[first]] = mm[first]
    return depth.reshape(im_h, im_w), xyz.reshape(im_h, im_w, 3)


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


def _write_points_ply(path: str, pts_mm: np.ndarray,
                      faces: np.ndarray | None = None) -> None:
    lines = ["ply", "format ascii 1.0", f"element vertex {len(pts_mm)}",
             "property float x", "property float y", "property float z"]
    if faces is not None:
        lines += [f"element face {len(faces)}",
                  "property list uchar int vertex_indices"]
    lines += ["end_header"] + [f"{x:.4f} {y:.4f} {z:.4f}"
                               for x, y, z in pts_mm]
    if faces is not None:
        lines += [f"3 {a} {b} {c}" for a, b, c in faces]
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


LMO_OBJS = {"ape": 1, "can": 5, "cat": 6, "driller": 8, "duck": 9,
            "eggbox": 10, "glue": 11, "holepuncher": 12}


def cube_faces(pts: np.ndarray) -> np.ndarray:
    """The 12 triangles [12, 3] of the cube whose surface samples are
    ``pts`` (``cube_points``), as indices of its 8 corners in ``pts``."""
    half = np.abs(pts).max()
    at_corner = np.all(np.isclose(np.abs(pts), half), axis=1)
    corner = {tuple(np.sign(pts[i]).astype(int)): int(i)
              for i in np.flatnonzero(at_corner)}
    faces = []
    for axis in range(3):
        u, v = [a for a in range(3) if a != axis]
        for side in (-1, 1):
            quad = []
            for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                key = [0, 0, 0]
                key[axis], key[u], key[v] = side, su, sv
                quad.append(corner[tuple(key)])
            faces += [(quad[0], quad[1], quad[2]), (quad[0], quad[2], quad[3])]
    return np.asarray(faces, np.int32)


# a cube's 4-fold discrete symmetry about z (90, 180 and 270 degrees), as
# ``symmetries_discrete`` stores it (row-major 4x4, translation in mm)
CUBE_Z_SYMMETRIES = [[c, -s, 0.0, 0.0, s, c, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0,
                      0.0, 0.0, 0.0, 1.0]
                     for c, s in ((0.0, 1.0), (-1.0, 0.0), (0.0, -1.0))]


def _write_models(ds: str, objs: dict[str, int], rng: np.random.RandomState,
                  fps_counts: tuple[int, ...] = (), faces: bool = False,
                  symmetric: tuple[int, ...] = ()) -> dict[int, float]:
    """Each object a cube of seeded half side: ``models/`` and
    ``models_eval/`` point meshes (mm) with ``models_info.json``, and with
    ``fps_counts`` a ``models/fps_points.pkl`` (metres, the BOP tools'
    ``fps{n}_and_center`` entries). With ``faces`` the eval meshes carry
    the cube's 12 triangles (VSD renders them); the objects in
    ``symmetric`` declare the cube's 4-fold z symmetry. Returns {obj_id:
    half side in m}."""
    from .assets import get_fps_and_center

    halves: dict[int, float] = {}
    info, info_eval = {}, {}
    for name, oid in objs.items():
        half = float(rng.uniform(0.03, 0.06))
        halves[oid] = half
        size = 2000.0 * half
        for sub, n_edge, table in (("models", 25, info),
                                   ("models_eval", 15, info_eval)):
            pts = cube_points(n_edge, half)
            _write_points_ply(os.path.join(ds, sub, f"obj_{oid:06d}.ply"),
                              pts * 1000.0, cube_faces(pts)
                              if faces and sub == "models_eval" else None)
            table[str(oid)] = {
                "diameter": size * np.sqrt(3), "min_x": -size / 2,
                "min_y": -size / 2, "min_z": -size / 2, "size_x": size,
                "size_y": size, "size_z": size}
            if oid in symmetric:
                table[str(oid)]["symmetries_discrete"] = CUBE_Z_SYMMETRIES
    for sub, table in (("models", info), ("models_eval", info_eval)):
        with open(os.path.join(ds, sub, "models_info.json"), "w") as f:
            json.dump(table, f)
    if fps_counts:
        fps = {str(oid): {f"fps{n}_and_center": get_fps_and_center(
            cube_points(25, halves[oid]).astype(np.float32), n)
            for n in fps_counts} for oid in halves}
        with open(os.path.join(ds, "models", "fps_points.pkl"), "wb") as f:
            pickle.dump(fps, f)
    return halves


def _render_scene(rng: np.random.RandomState, K: np.ndarray, H: int, W: int,
                  insts: list[tuple[int, float]]) -> list[dict]:
    """Cubes on a 4 x 2 grid of the view, 12-14 cm apart and 0.85-1.15 m
    away, so that neighbours overlap: for each (obj_id, half) its pose,
    amodal depth and xyz render, and its visible mask after the z-buffer
    of all of them."""
    out = []
    for i, (oid, half) in enumerate(insts):
        R = _rodrigues(rng.randn(3) * 0.8)
        t = np.array([-0.18 + 0.12 * (i % 4) + rng.uniform(-0.02, 0.02),
                      -0.07 + 0.14 * (i // 4 % 2) + rng.uniform(-0.02, 0.02),
                      rng.uniform(0.85, 1.15)])
        depth, xyz = render_cube_depth(R, t, K, H, W, half=half,
                                       n_samples=90)
        out.append({"obj_id": oid, "R": R, "t": t, "depth": depth,
                    "xyz": xyz})
    stack = np.stack([np.where(o["depth"] > 0, o["depth"], np.inf)
                      for o in out])
    winner = np.where(np.isfinite(stack.min(0)), stack.argmin(0), -1)
    for i, o in enumerate(out):
        o["visib"] = winner == i
    return out


def _write_bop_scene(sdir: str, frames: list[list[dict]], K: np.ndarray,
                     rng: np.random.RandomState, rgb_format: str | list[str],
                     depth_scale: float, xyz_crops: bool,
                     plane: float = 1.3) -> None:
    """One BOP scene directory: per frame the RGB (``rgb_format`` "png",
    "jpeg" as BOP-PBR stores it, or "tif", ITODD's gray frames as
    ``gray/<im>.tif``, LZW with the horizontal predictor; one format for
    every frame or a list of one a frame), 16-bit depth in units of
    ``depth_scale`` mm over a plane at ``plane`` m, each instance's visible
    mask (and GT xyz crop), and scene_gt / scene_camera / scene_gt_info."""
    H, W = frames[0][0]["depth"].shape
    scene_gt, scene_cam, scene_info = {}, {}, {}
    for im_id, objs in enumerate(frames):
        rgb = _backdrop(rng, H, W)
        depth = np.full((H, W), plane)
        for o in objs:      # the visible masks are disjoint
            m = o["visib"]
            rgb[m] = 128 + 1000.0 * o["xyz"][m]
            depth[m] = o["depth"][m]
        rgb = np.clip(rgb + rng.normal(0, 4, rgb.shape), 0, 255).astype(
            np.uint8)
        fmt = rgb_format if isinstance(rgb_format, str) \
            else rgb_format[im_id]
        if fmt == "jpeg":
            write_jpeg(os.path.join(sdir, "rgb", f"{im_id:06d}.jpg"), rgb,
                       quality=90)
        elif fmt == "tif":
            write_tif(os.path.join(sdir, "gray", f"{im_id:06d}.tif"),
                      np.round(rgb.mean(-1)).astype(np.uint8))
        else:
            write_png(os.path.join(sdir, "rgb", f"{im_id:06d}.png"), rgb)
        write_png(os.path.join(sdir, "depth", f"{im_id:06d}.png"),
                  np.round(depth * 1000.0 / depth_scale).astype(np.uint16))
        gts, infos = [], []
        for inst, o in enumerate(objs):
            stem = f"{im_id:06d}_{inst:06d}"
            write_png(os.path.join(sdir, "mask_visib", f"{stem}.png"),
                      o["visib"].astype(np.uint8) * 255)
            if xyz_crops:
                _write_xyz_crop(os.path.join(sdir, "xyz_crop", f"{stem}.pkl"),
                                o["xyz"])
            full = o["depth"] > 0

            def box(m):
                ys, xs = np.nonzero(m)
                if not xs.size:
                    return [-1, -1, -1, -1]
                return [int(xs.min()), int(ys.min()),
                        int(xs.max() - xs.min()), int(ys.max() - ys.min())]

            gts.append({"cam_R_m2c": o["R"].reshape(-1).tolist(),
                        "cam_t_m2c": (o["t"] * 1000.0).tolist(),
                        "obj_id": o["obj_id"]})
            infos.append({"bbox_obj": box(full), "bbox_visib": box(o["visib"]),
                          "px_count_all": int(full.sum()),
                          "px_count_visib": int(o["visib"].sum()),
                          "visib_fract": float(o["visib"].sum()
                                               / max(full.sum(), 1))})
        scene_gt[str(im_id)] = gts
        scene_cam[str(im_id)] = {"cam_K": K.reshape(-1).tolist(),
                                 "depth_scale": depth_scale}
        scene_info[str(im_id)] = infos
    for fname, table in (("scene_gt.json", scene_gt),
                         ("scene_camera.json", scene_cam),
                         ("scene_gt_info.json", scene_info)):
        with open(os.path.join(sdir, fname), "w") as f:
            json.dump(table, f)


def write_lmo_tree(root: str, train_frames: int, pbr_scenes: int,
                   pbr_frames: int, test_frames: int,
                   insts_per_frame: int = 8, seed: int = 0) -> None:
    """A LineMOD-Occluded BOP tree under ``root/lmo``, every frame 480x640
    with LineMOD's camera and ``insts_per_frame`` occluding cubes of the 8
    lmo objects (taken in turn; their own seeded sizes):

    - ``models/`` and ``models_eval/`` with ``models_info.json``, and
      ``models/fps_points.pkl`` (4, 8, 16 and 32 keypoints);
    - ``train/000002`` (``lmo_train``): PNG RGB, depth in mm, visible
      masks and GT xyz crops;
    - ``train_pbr/<scene>`` for scenes 0..``pbr_scenes``-1
      (``lmo_pbr_train``): JPEG RGB (quality 90, 4:2:0), depth in 0.1 mm
      (``depth_scale`` 0.1), visible masks, no xyz crops;
    - ``test/000002`` (``lmo_bop_test``) as the train scene, and
      ``test_targets_bop19.json`` listing every visible instance."""
    rng = np.random.RandomState(seed)
    H, W = 480, 640
    ds = os.path.join(root, "lmo")
    halves = _write_models(ds, LMO_OBJS, rng, fps_counts=(4, 8, 16, 32))
    ids = list(LMO_OBJS.values())

    def scene(n_frames, offset):
        return [_render_scene(rng, LM_K, H, W, [
            (ids[(offset + f + i) % len(ids)],
             halves[ids[(offset + f + i) % len(ids)]])
            for i in range(insts_per_frame)]) for f in range(n_frames)]

    _write_bop_scene(os.path.join(ds, "train", "000002"),
                     scene(train_frames, 0), LM_K, rng, rgb_format="png",
                     depth_scale=1.0, xyz_crops=True)
    for s in range(pbr_scenes):
        _write_bop_scene(os.path.join(ds, "train_pbr", f"{s:06d}"),
                         scene(pbr_frames, 3 * s + 1), LM_K, rng,
                         rgb_format="jpeg",
                         depth_scale=0.1, xyz_crops=False)
    test = scene(test_frames, 5)
    _write_bop_scene(os.path.join(ds, "test", "000002"), test, LM_K, rng,
                     rgb_format="png", depth_scale=1.0, xyz_crops=False)
    targets = [{"scene_id": 2, "im_id": im_id, "obj_id": o["obj_id"],
                "inst_count": 1}
               for im_id, objs in enumerate(test) for o in objs
               if o["visib"].any()]
    with open(os.path.join(ds, "test_targets_bop19.json"), "w") as f:
        json.dump(targets, f)


# the BOP datasets ``write_bop_tree`` writes: (the real train subdir and
# scene | None, the PBR train scenes, the test subdir and scene, whether
# the test split has BOP19 targets, depth_scale), from ``data/bop.py``'s
# splits; itodd's PBR scene 49 is its SO validation split
BOP_TREES = {
    "ycbv": (("train_real", 0), (0,), ("test", 48), True, 0.1),
    "tless": (("train_primesense", 1), (), ("test_primesense", 1), True,
              0.1),
    "tudl": (("train_real", 1), (), ("test", 1), True, 1.0),
    "hb": (None, (0,), ("val_primesense", 3), False, 0.1),
    "icbin": (None, (0,), ("test", 1), True, 0.1),
    "itodd": (None, (0, 49), ("val", 1), False, 0.1),
}


def _render_mesh_scene(rng: np.random.RandomState, K: np.ndarray, H: int,
                       W: int, insts: list[tuple[int, float]],
                       hidden: bool) -> list[dict]:
    """Cubes rendered with the port's rasterizer on a 4 x 2 grid of the
    view, as ``_render_scene`` places them, with the scene scaled by
    fx / 572 so they cover as many pixels as at LineMOD's focal length;
    with ``hidden`` one more cube sits 15 cm behind the first, shifted so
    that a sliver of it shows. For each its pose, amodal depth and xyz,
    and its visible mask after the z-buffer of all."""
    from ..ops.rasterizer import render_mesh

    s = float(K[0, 0]) / 572.0
    poses = []
    for i, (oid, half) in enumerate(insts):
        R = _rodrigues(rng.randn(3) * 0.8)
        t = np.array([-0.18 + 0.12 * (i % 4) + rng.uniform(-0.02, 0.02),
                      -0.07 + 0.14 * (i // 4 % 2) + rng.uniform(-0.02, 0.02),
                      rng.uniform(0.85, 1.15)]) * s
        poses.append((oid, half, R, t))
    if hidden:
        oid, half, _, t0 = poses[0]
        t = t0 * (t0[2] + 0.15 * s) / t0[2] \
            + np.array([0.5 * half, 0.0, 0.0])
        poses.append((oid, half, _rodrigues(rng.randn(3) * 0.8), t))
    out = []
    for oid, half, R, t in poses:
        corners = cube_points(2, half)
        depth, xyz = render_mesh(corners, cube_faces(corners), K, R, t, H, W)
        out.append({"obj_id": oid, "R": R, "t": t, "depth": depth,
                    "xyz": xyz})
    stack = np.stack([np.where(o["depth"] > 0, o["depth"], np.inf)
                      for o in out])
    winner = np.where(np.isfinite(stack.min(0)), stack.argmin(0), -1)
    for i, o in enumerate(out):
        o["visib"] = winner == i
    return out


def _write_targets(path: str, scene_id: int, frames: list[list[dict]],
                   im_ids: list[int]) -> None:
    """A BOP19 targets file: every visible instance of the frames in
    ``im_ids``, counted by (image, object)."""
    counts: dict[tuple[int, int], int] = {}
    for im_id in im_ids:
        for o in frames[im_id]:
            if o["visib"].any():
                k = (im_id, o["obj_id"])
                counts[k] = counts.get(k, 0) + 1
    with open(path, "w") as f:
        json.dump([{"scene_id": scene_id, "im_id": im_id, "obj_id": oid,
                    "inst_count": n}
                   for (im_id, oid), n in sorted(counts.items())], f)


def write_bop_tree(root: str, dataset: str, objs: dict[str, int] | None = None,
                   train_frames: int = 2, pbr_frames: int = 2,
                   test_frames: int = 2, insts_per_frame: int = 4,
                   seed: int = 0) -> None:
    """A BOP tree of ``dataset`` (ycbv, tless, tudl, hb, icbin or itodd) under
    ``root/<dataset>``: the dataset's frame size and camera (``data/refs``)
    and its splits' directories (``data/bop.py``), every frame
    ``insts_per_frame`` occluding cubes of ``objs`` (name -> obj id,
    default the dataset's first four objects) taken in turn, rendered with
    the port's rasterizer, plus one mostly hidden cube a frame
    (``visib_fract`` under 0.2, which ycbv's filter drops):

    - ``models/`` and ``models_eval/`` of every object of the dataset, each
      a cube of its own seeded size, with ``models_info.json`` (the first
      of ``objs`` declares the cube's 4-fold z symmetry), the eval meshes
      with faces, and ``models/fps_points.pkl`` (4, 8, 16 and 32
      keypoints);
    - the real train scene, where the dataset has one (PNG RGB, GT xyz
      crops), and the ``train_pbr`` scenes where it has PBR training
      (JPEG RGB, no xyz crops; for itodd scenes 0 and 49, every frame
      but scene 0's first PNG, since the JPEG reader is slow at
      960x1280);
    - the test scene (PNG, no crops; itodd's val scene gray TIFF frames,
      ``gray/<im>.tif``) and, where the split scores BOP19,
      ``test_targets_bop19.json``; for ycbv ``image_sets/keyframe.txt``
      listing all test frames but the last, and ``image_sets/train.txt``
      listing every real train frame."""
    from .refs import get_ref

    real, pbr, (test_sub, test_scene), has_targets, dscale = \
        BOP_TREES[dataset]
    ref = get_ref(dataset)
    if objs is None:
        objs = {name: ref.obj2id[name] for name in ref.objects[:4]}
    rng = np.random.RandomState(seed)
    H, W = ref.height, ref.width
    K = ref.K()
    ds = os.path.join(root, dataset)
    ids = list(objs.values())
    halves = _write_models(ds, ref.obj2id, rng, fps_counts=(4, 8, 16, 32),
                           faces=True, symmetric=(ids[0],))
    plane = 1.3 * float(K[0, 0]) / 572.0

    def scene(n_frames, offset):
        return [_render_mesh_scene(rng, K, H, W, [
            (ids[(offset + f + i) % len(ids)],
             halves[ids[(offset + f + i) % len(ids)]])
            for i in range(insts_per_frame)], hidden=True)
            for f in range(n_frames)]

    itodd = dataset == "itodd"
    if real is not None:
        sub, sid = real
        _write_bop_scene(os.path.join(ds, sub, f"{sid:06d}"),
                         scene(train_frames, 0), K, rng, rgb_format="png",
                         depth_scale=dscale, xyz_crops=True, plane=plane)
    for n, sid in enumerate(pbr):
        _write_bop_scene(os.path.join(ds, "train_pbr", f"{sid:06d}"),
                         scene(pbr_frames, 1), K, rng,
                         rgb_format=["jpeg" if n == f == 0 else "png"
                                     for f in range(pbr_frames)]
                         if itodd else "jpeg",
                         depth_scale=0.1, xyz_crops=False, plane=plane)
    test = scene(test_frames, 2)
    _write_bop_scene(os.path.join(ds, test_sub, f"{test_scene:06d}"), test,
                     K, rng, rgb_format="tif" if itodd else "png",
                     depth_scale=dscale, xyz_crops=False, plane=plane)
    keyframes = list(range(test_frames))
    if dataset == "ycbv":
        keyframes = keyframes[:-1] or keyframes
        os.makedirs(os.path.join(ds, "image_sets"), exist_ok=True)
        with open(os.path.join(ds, "image_sets", "keyframe.txt"), "w") as f:
            f.write("".join(f"{test_scene:04d}/{i:06d}\n" for i in keyframes))
        with open(os.path.join(ds, "image_sets", "train.txt"), "w") as f:
            f.write("".join(f"{real[1]:04d}/{i:06d}\n"
                            for i in range(train_frames)))
    if has_targets:
        _write_targets(os.path.join(ds, "test_targets_bop19.json"),
                       test_scene, test, keyframes)


def write_mp6d_tree(root: str, objs: dict[str, int] | None = None,
                    train_frames: int = 2, test_frames: int = 2,
                    insts_per_frame: int = 4, seed: int = 0) -> None:
    """An MP6D tree in the ``ycb_style`` layout under ``root/mp6d``, at
    MP6D's frame size and camera, every frame ``insts_per_frame``
    occluding cubes of ``objs`` (name -> obj id, default the first four
    of MP6D's 20) taken in turn, point-splat rendered:

    - ``models/`` and ``models_eval/`` of all 20 objects (cubes of seeded
      sizes, ``models_info.json``, the eval meshes with faces,
      ``models/fps_points.pkl``);
    - ``data/0000`` (train) and ``data/0001`` (test): per frame
      ``<im>-color.png``, ``<im>-depth.png`` (mm), ``<im>-label.png``
      (each visible pixel its object's id) and ``<im>-meta.mat`` written
      by ``scipy.io.savemat`` (``cls_indexes``, ``poses`` [3, 4, n] with
      the translation in mm, ``intrinsic_matrix``, ``factor_depth`` 1 mm a
      unit); no xyz crops;
    - ``image_set/train_data_list.txt`` and ``test_data_list.txt`` of
      ``data/<scene>/<im>`` lines."""
    from scipy.io import savemat

    from .refs import get_ref

    ref = get_ref("mp6d")
    if objs is None:
        objs = {name: ref.obj2id[name] for name in ref.objects[:4]}
    rng = np.random.RandomState(seed)
    H, W = ref.height, ref.width
    K = ref.K().astype(np.float64)
    ds = os.path.join(root, "mp6d")
    ids = list(objs.values())
    halves = _write_models(ds, ref.obj2id, rng, fps_counts=(4, 8, 16, 32),
                           faces=True)
    os.makedirs(os.path.join(ds, "image_set"), exist_ok=True)
    for part, sid, n_frames, offset in (("train", 0, train_frames, 0),
                                        ("test", 1, test_frames, 2)):
        lines = []
        for im_id in range(n_frames):
            insts = _render_scene(rng, K, H, W, [
                (ids[(offset + im_id + i) % len(ids)],
                 halves[ids[(offset + im_id + i) % len(ids)]])
                for i in range(insts_per_frame)])
            rgb = _backdrop(rng, H, W)
            depth = np.full((H, W), 1.3)
            label = np.zeros((H, W), np.uint8)
            for o in insts:  # the visible masks are disjoint
                m = o["visib"]
                rgb[m] = 128 + 1000.0 * o["xyz"][m]
                depth[m] = o["depth"][m]
                label[m] = o["obj_id"]
            rgb = np.clip(rgb + rng.normal(0, 4, rgb.shape), 0,
                          255).astype(np.uint8)
            base = os.path.join(ds, "data", f"{sid:04d}", f"{im_id:06d}")
            write_png(base + "-color.png", rgb)
            write_png(base + "-depth.png",
                      np.round(depth * 1000.0).astype(np.uint16))
            write_png(base + "-label.png", label)
            savemat(base + "-meta.mat", {
                "cls_indexes": np.array([[o["obj_id"]] for o in insts]),
                "poses": np.stack([np.hstack([o["R"], o["t"][:, None]
                                              * 1000.0]) for o in insts],
                                  -1),
                "intrinsic_matrix": K,
                "factor_depth": np.array([[1.0]])})
            lines.append(f"data/{sid:04d}/{im_id:06d}\n")
        with open(os.path.join(ds, "image_set", f"{part}_data_list.txt"),
                  "w") as f:
            f.write("".join(lines))


def write_blender_tree(root: str, objs: dict[str, int],
                       frames_per_obj: int, seed: int = 0) -> None:
    """LineMOD's Blender renders (BB8's training set) under
    ``root/lm_renders_blender/renders``, beside a ``write_lm_tree`` tree
    whose meshes they borrow (each cube's size is read back from
    ``root/lm/models/models_info.json``): for each object,
    ``<obj>/<i>.jpg`` (the cube over a synthetic backdrop, JPEG quality
    95), ``<i>_depth_opengl.png`` (the cube's depth in mm, 0 elsewhere),
    ``<i>_mask_opengl.png``, the GT xyz crop ``<i>_xyz_bop.pkl``, and
    ``<obj>_gt.json`` mapping each id to its pose (mm), box and
    visibility."""
    rng = np.random.RandomState(seed)
    H, W = 480, 640
    with open(os.path.join(root, "lm", "models", "models_info.json")) as f:
        sizes = {int(k): v["size_x"] for k, v in json.load(f).items()}
    ds = os.path.join(root, "lm_renders_blender", "renders")
    for name, oid in objs.items():
        half = sizes[oid] / 2000.0
        gt = {}
        for i in range(frames_per_obj):
            R = _rodrigues(rng.randn(3) * 0.8)
            t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.07, 0.07),
                          rng.uniform(0.7, 1.0)])
            depth, xyz = render_cube_depth(R, t, LM_K, H, W, half=half)
            obj = depth > 0
            base = os.path.join(ds, name, str(i))
            write_jpeg(base + ".jpg",
                       _shade(rng, obj, xyz, _backdrop(rng, H, W)))
            write_png(base + "_depth_opengl.png",
                      np.round(depth * 1000.0).astype(np.uint16))
            write_png(base + "_mask_opengl.png", obj.astype(np.uint8) * 255)
            _write_xyz_crop(base + "_xyz_bop.pkl", xyz)
            ys, xs = np.nonzero(obj)
            gt[str(i)] = [{"cam_R_m2c": R.reshape(-1).tolist(),
                           "cam_t_m2c": (t * 1000.0).tolist(),
                           "bbox_visib": [int(xs.min()), int(ys.min()),
                                          int(xs.max() - xs.min()),
                                          int(ys.max() - ys.min())],
                           "visib_fract": 1.0}]
        with open(os.path.join(ds, f"{name}_gt.json"), "w") as f:
            json.dump(gt, f)


MINI_OBJS = {"ape": 1, "can": 5, "driller": 8}


def _subdivide(verts: np.ndarray, faces: np.ndarray,
               n: int) -> tuple[np.ndarray, np.ndarray]:
    """Midpoint subdivision, n times: each triangle into four."""
    for _ in range(n):
        vl = [tuple(v) for v in verts]
        mids: dict[tuple[int, int], int] = {}

        def mid(a, b):
            k = (min(a, b), max(a, b))
            if k not in mids:
                mids[k] = len(vl)
                vl.append(tuple((np.asarray(vl[a]) + np.asarray(vl[b]))
                                / 2.0))
            return mids[k]

        out = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            out += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        verts, faces = np.asarray(vl, np.float64), np.asarray(out, np.int32)
    return verts, faces


def _box_mesh(c, h) -> tuple[np.ndarray, np.ndarray]:
    v = np.array([(c[0] + sx * h[0], c[1] + sy * h[1], c[2] + sz * h[2])
                  for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    return v, np.array([t for a, b, c_, d in quads
                        for t in ((a, b, c_), (a, c_, d))], np.int32)


def mini_meshes() -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """The mini dataset's three meshes {obj_id: (verts in mm, faces)}: an
    irregular tetrahedron (ape, asymmetric, ~90 mm), an 80 mm cube (can,
    4-fold z symmetry) and an L-prism of two boxes (driller,
    asymmetric), subdivided for denser vertex sets."""
    ape = _subdivide(np.array([[0, 0, 55], [50, -30, -35], [-45, -35, -30],
                               [5, 60, -30]], np.float64),
                     np.array([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]]),
                     3)
    can = _subdivide(*_box_mesh((0, 0, 0), (40, 40, 40)), 2)
    a, fa = _box_mesh((10, -27.5, 0), (50, 12.5, 20))
    b, fb = _box_mesh((-27.5, 12.5, 0), (12.5, 27.5, 20))
    driller = _subdivide(np.concatenate([a, b]),
                         np.concatenate([fa, fb + len(a)]), 2)
    return {1: ape, 5: can, 8: driller}


def _random_rotation(rng: np.random.RandomState) -> np.ndarray:
    q, r = np.linalg.qr(rng.randn(3, 3))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def write_mini_tree(root: str, n_train: int = 4, n_test: int = 2,
                    seed: int = 0) -> None:
    """The mini rehearsal dataset under ``root/lm`` in the layout of the
    JAX package's ``tools/make_mini_bop.py``: ``mini_meshes`` as
    ``models/`` and ``models_eval/`` PLY meshes with faces and
    ``models_info.json`` (the cube declares its z symmetry), the train
    scene 91 (``lm_mini_train``) and the test scene 92
    (``lm_mini_test``) of 480x640 frames with LineMOD's camera, each frame
    2-3 of the objects clustered so that they occlude (fully hidden ones
    kept, as BOP keeps them), rendered with the port's rasterizer (RGB by
    model coordinate, depth in mm, visible masks; no xyz crops), and
    ``test_targets_mini.json`` (every instance over 5% visible) and
    ``detections_mini.json`` (jittered boxes, every ninth instance
    missed)."""
    from ..ops.rasterizer import render_mesh

    rng = np.random.RandomState(seed)
    H, W = 480, 640
    K = LM_K
    meshes = mini_meshes()
    ds = os.path.join(root, "lm")
    info = {}
    for oid, (v, f) in meshes.items():
        for sub in ("models", "models_eval"):
            _write_points_ply(os.path.join(ds, sub, f"obj_{oid:06d}.ply"),
                              v, f)
        lo, hi = v.min(0), v.max(0)
        d2 = ((v[:, None] - v[None]) ** 2).sum(-1)
        info[str(oid)] = {
            "diameter": float(np.sqrt(d2.max())), "min_x": float(lo[0]),
            "min_y": float(lo[1]), "min_z": float(lo[2]),
            "size_x": float(hi[0] - lo[0]), "size_y": float(hi[1] - lo[1]),
            "size_z": float(hi[2] - lo[2])}
        if oid == 5:
            info[str(oid)]["symmetries_discrete"] = CUBE_Z_SYMMETRIES
    for sub in ("models", "models_eval"):
        with open(os.path.join(ds, sub, "models_info.json"), "w") as f:
            json.dump(info, f)
    meshes_m = {oid: (v / 1000.0, f) for oid, (v, f) in meshes.items()}
    obj_ids = sorted(meshes_m)
    targets: list[dict] = []
    dets: list[dict] = []
    for sub, scene_id, n_images in (("train", 91, n_train),
                                    ("test", 92, n_test)):
        sdir = os.path.join(ds, sub, f"{scene_id:06d}")
        scene_gt, scene_cam, scene_info = {}, {}, {}
        n_rois = 0
        for im_id in range(n_images):
            chosen = rng.choice(obj_ids, size=rng.randint(2, 4),
                                replace=False)
            base = rng.uniform(-0.06, 0.06, 2)
            insts, renders = [], []
            for oid in chosen:
                R = _random_rotation(rng)
                t = np.array([base[0] + rng.uniform(-0.07, 0.07),
                              base[1] + rng.uniform(-0.06, 0.06),
                              rng.uniform(0.55, 0.85)])
                insts.append((int(oid), R, t))
                renders.append(render_mesh(*meshes_m[int(oid)], K, R, t,
                                           H, W))
            depth = np.zeros((H, W), np.float32)
            owner = np.full((H, W), -1)
            for i, (d, _) in enumerate(renders):
                m = (d > 0) & ((depth <= 0) | (d < depth))
                depth = np.where(m, d, depth)
                owner = np.where(m, i, owner)
            rgb = rng.randint(30, 70, (H, W, 3)).astype(np.float64)
            for i, ((oid, _, _), (_, xyz)) in enumerate(zip(insts, renders)):
                v = meshes_m[oid][0]
                albedo = (xyz / (v.max(0) - v.min(0)) + 0.5) * 175.0 + 40.0
                rgb = np.where((owner == i)[..., None], albedo, rgb)
            write_png(os.path.join(sdir, "rgb", f"{im_id:06d}.png"),
                      np.clip(rgb, 0, 255).astype(np.uint8))
            write_png(os.path.join(sdir, "depth", f"{im_id:06d}.png"),
                      np.round(depth * 1000.0).astype(np.uint16))
            gts, infos, counts = [], [], {}
            for j, ((oid, R, t), (d, _)) in enumerate(zip(insts, renders)):
                vis = owner == j
                vf = float(vis.sum()) / max(float((d > 0).sum()), 1.0)
                ys, xs = np.nonzero(vis)
                bbox = [0, 0, 0, 0] if not xs.size else [
                    int(xs.min()), int(ys.min()),
                    int(xs.max() - xs.min() + 1),
                    int(ys.max() - ys.min() + 1)]
                write_png(os.path.join(sdir, "mask_visib",
                                       f"{im_id:06d}_{j:06d}.png"),
                          vis.astype(np.uint8) * 255)
                gts.append({"cam_R_m2c": R.reshape(-1).tolist(),
                            "cam_t_m2c": (t * 1000.0).tolist(),
                            "obj_id": oid})
                infos.append({"bbox_visib": bbox, "visib_fract": vf})
                if sub != "test" or vf <= 0.05:
                    continue
                counts[oid] = counts.get(oid, 0) + 1
                n_rois += 1
                if n_rois % 9 == 0:
                    continue
                jit = rng.randint(-3, 4, 4)
                dets.append({"scene_id": scene_id, "im_id": im_id,
                             "obj_id": oid,
                             "bbox_est": [float(bbox[0] + jit[0]),
                                          float(bbox[1] + jit[1]),
                                          float(max(bbox[2] + jit[2], 8)),
                                          float(max(bbox[3] + jit[3], 8))],
                             "score": float(rng.uniform(0.5, 1.0)),
                             "time": 0.05})
            targets += [{"im_id": im_id, "inst_count": n, "obj_id": oid,
                         "scene_id": scene_id}
                        for oid, n in sorted(counts.items())]
            scene_gt[str(im_id)] = gts
            scene_cam[str(im_id)] = {"cam_K": K.reshape(-1).tolist(),
                                     "depth_scale": 1.0}
            scene_info[str(im_id)] = infos
        for fname, table in (("scene_gt.json", scene_gt),
                             ("scene_camera.json", scene_cam),
                             ("scene_gt_info.json", scene_info)):
            with open(os.path.join(sdir, fname), "w") as f:
                json.dump(table, f)
    with open(os.path.join(ds, "test_targets_mini.json"), "w") as f:
        json.dump(targets, f)
    with open(os.path.join(ds, "detections_mini.json"), "w") as f:
        json.dump(dets, f)


def write_bg_pool(root: str, seed: int = 0) -> str:
    """A background pool in the VOC layout under ``root``
    (``JPEGImages/*.jpg`` and ``extra/*.png``): JPEG files of the port's
    encoder (4:2:0 and 4:4:4, one gray) and PNG files, of sizes that take
    each path of ``cv2.resize`` to a 480x640 frame (up, down, a non-integer
    factor, an exact 2x down). Returns the pool's directory."""
    rng = np.random.RandomState(seed)
    files = (("JPEGImages/2008_000001.jpg", (375, 500), "420"),
             ("JPEGImages/2008_000002.jpg", (500, 333), "444"),
             ("JPEGImages/2008_000003.jpg", (960, 1280), "420"),
             ("JPEGImages/2008_000004.jpg", (240, 320), "gray"),
             ("extra/wall.png", (50, 70), None),
             ("extra/floor.png", (480, 640), None))
    for rel, (h, w), kind in files:
        img = np.clip(_backdrop(rng, h, w) + rng.normal(0, 12, (h, w, 3)),
                      0, 255).astype(np.uint8)
        path = os.path.join(root, rel)
        if kind is None:
            write_png(path, img)
        else:
            write_jpeg(path, img[..., 1] if kind == "gray" else img,
                       quality=85, subsample=kind == "420")
    return root


# JPEG's Annex K tables as a baseline file stores them: the quantization
# tables (luma, chroma) in zig-zag order at quality 50, and the Huffman
# tables as (counts of the codes of length 1..16, symbols), keyed by
# (class: 0 DC / 1 AC, id: 0 luma / 1 chroma)
_JPEG_QUANT = tuple(bytes.fromhex(h) for h in (
    "100b0c0e0c0a100e0d0e1211101318281a181616183123251d283a333d3c3933383740"
    "485c4e404457453738506d51575f626768673e4d71797064785c656763",
    "1112121815182f1a1a2f634238426363636363636363636363636363636363636363"
    "636363636363636363636363636363636363636363636363636363636363"))
_JPEG_HUFF = {
    (0, 0): ("00010501010101010100000000000000", "000102030405060708090a0b"),
    (0, 1): ("00030101010101010101010000000000", "000102030405060708090a0b"),
    (1, 0): ("0002010303020403050504040000017d",
             "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
             "2433627282090a161718191a25262728292a3435363738393a434445464748"
             "494a535455565758595a636465666768696a737475767778797a8384858687"
             "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2"
             "c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4"
             "f5f6f7f8f9fa"),
    (1, 1): ("00020102040403040705040400010277",
             "000102031104052131061241510761711322328108144291a1b1c109233352f0"
             "156272d10a162434e125f11718191a262728292a35363738393a4344454647"
             "48494a535455565758595a636465666768696a737475767778797a82838485"
             "868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9"
             "bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4"
             "f5f6f7f8f9fa"),
}
_ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26,
           33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56,
           57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38,
           31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)


def _huffman_codes(counts: bytes, symbols: bytes) -> dict[int, tuple[int,
                                                                     int]]:
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def encode_jpeg(img: np.ndarray, quality: int = 95,
                subsample: bool = True) -> bytes:
    """A baseline JFIF JPEG of uint8 [H, W] (gray) or [H, W, 3] RGB: the
    standard tables scaled to ``quality`` as libjpeg scales them, float
    DCT, 4:2:0 chroma (2x2 means) with ``subsample`` else 4:4:4, one
    interleaved scan, no restart markers. For fixtures: the card's machine
    has no other JPEG writer."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.ndim not in (2, 3) \
            or (a.ndim == 3 and a.shape[2] != 3):
        raise ValueError(f"encode_jpeg: uint8 [H,W] or [H,W,3], got "
                         f"{a.dtype} {a.shape}")
    H, W = a.shape[:2]
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    qz = [np.clip((np.frombuffer(t, np.uint8).astype(np.int64) * scale + 50)
                  // 100, 1, 255) for t in _JPEG_QUANT]   # zig-zag order
    qnat = []
    for t in qz:
        nat = np.zeros(64, np.int64)
        nat[list(_ZIGZAG)] = t
        qnat.append(nat.reshape(8, 8))
    x = a.astype(np.float64)
    if a.ndim == 2:
        planes, samp = [x], [(1, 1)]
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
        f = 2 if subsample else 1
        samp = [(f, f), (1, 1), (1, 1)]
    fmax = samp[0][0]
    mcux, mcuy = -(-W // (8 * fmax)), -(-H // (8 * fmax))
    ph, pw = 8 * fmax * mcuy, 8 * fmax * mcux
    k = np.arange(8)
    dct = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    dct[0] /= np.sqrt(2.0)
    per_comp = []
    for ci, (p, (f, _)) in enumerate(zip(planes, samp)):
        p = np.pad(p, ((0, ph - H), (0, pw - W)), mode="edge")
        if f != fmax:
            p = p.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3))
        bh, bw = p.shape[0] // 8, p.shape[1] // 8
        blocks = (p - 128.0).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ux,abxy,vy->abuv", dct, blocks, dct)
        qt = qnat[min(ci, 1)]
        qc = np.round(coef / qt).astype(np.int64).reshape(bh, bw, 64)
        qc = qc[..., list(_ZIGZAG)]                     # zig-zag order
        # MCU order: [mcuy, mcux, f*f blocks]
        qc = qc.reshape(mcuy, f, mcux, f, 64).transpose(0, 2, 1, 3, 4)
        per_comp.append(qc.reshape(mcuy * mcux, f * f, 64))
    order = np.concatenate(per_comp, axis=1)            # [mcus, blocks, 64]
    owner = [ci for ci, (f, _) in enumerate(samp) for _ in range(f * f)]
    tables = {key: _huffman_codes(bytes.fromhex(c), bytes.fromhex(s))
              for key, (c, s) in _JPEG_HUFF.items()}
    codes: list[int] = []
    lens: list[int] = []
    pred = [0] * len(planes)
    for mcu in order.tolist():
        for ci, blk in zip(owner, mcu):
            dc_t, ac_t = tables[(0, min(ci, 1))], tables[(1, min(ci, 1))]
            diff = blk[0] - pred[ci]
            pred[ci] = blk[0]
            s = abs(diff).bit_length()
            codes.append(dc_t[s][0])
            lens.append(dc_t[s][1])
            if s:
                codes.append(diff if diff > 0 else diff + (1 << s) - 1)
                lens.append(s)
            run = 0
            for v in blk[1:]:
                if not v:
                    run += 1
                    continue
                while run > 15:
                    codes.append(ac_t[0xF0][0])
                    lens.append(ac_t[0xF0][1])
                    run -= 16
                s = abs(v).bit_length()
                code, n = ac_t[(run << 4) | s]
                codes.extend((code, v if v > 0 else v + (1 << s) - 1))
                lens.extend((n, s))
                run = 0
            if run:
                codes.append(ac_t[0x00][0])
                lens.append(ac_t[0x00][1])
    c = np.asarray(codes, np.int64)
    n = np.asarray(lens, np.int64)
    owner_bit = np.repeat(np.arange(c.size), n)
    within = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    bits = ((c[owner_bit] >> (n[owner_bit] - 1 - within)) & 1).astype(
        np.uint8)
    bits = np.concatenate([bits, np.ones(-bits.size % 8, np.uint8)])
    scan = np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")

    def segment(marker: int, body: bytes) -> bytes:
        return bytes((0xFF, marker)) + (len(body) + 2).to_bytes(2, "big") \
            + body

    nq = 1 if len(planes) == 1 else 2
    dqt = b"".join(bytes((i,)) + qz[i].astype(np.uint8).tobytes()
                   for i in range(nq))
    sof = bytes((8,)) + H.to_bytes(2, "big") + W.to_bytes(2, "big") \
        + bytes((len(planes),)) + b"".join(
            bytes((ci + 1, (f << 4) | f, min(ci, 1)))
            for ci, (f, _) in enumerate(samp))
    dht = b"".join(bytes(((cls << 4) | tid,)) + bytes.fromhex(cnt)
                   + bytes.fromhex(sym)
                   for (cls, tid), (cnt, sym) in _JPEG_HUFF.items()
                   if tid < nq)
    sos = bytes((len(planes),)) + b"".join(
        bytes((ci + 1, (min(ci, 1) << 4) | min(ci, 1)))
        for ci in range(len(planes))) + bytes((0, 63, 0))
    return (b"\xff\xd8"
            + segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + segment(0xDB, dqt) + segment(0xC0, sof) + segment(0xC4, dht)
            + segment(0xDA, sos) + scan + b"\xff\xd9")


def write_jpeg(path: str, img: np.ndarray, quality: int = 95,
               subsample: bool = True) -> None:
    """``encode_jpeg`` into a file (its directory made as needed)."""
    data = encode_jpeg(img, quality, subsample)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


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
