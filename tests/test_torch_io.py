"""The port's data layer against the JAX package and OpenCV: the PNG codec,
PLY / BOP JSON / BOP19 CSV IO, split records, detections and the per-class
asset banks.

Tolerances: decoded images, PLY arrays, scene JSON, records, detections
and FPS keypoints are held equal (the same integers or the same float
operations on both sides); the CSV byte for byte; symmetry banks within
1e-7 (float64 products rounded to float32 on both sides).
"""

import json
import os
import pickle
import struct
import zlib

import cv2
import numpy as np
import pytest

import rdpn6d_tpu.data.refs as jrefs
import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu.data import inout as jio
from rdpn6d_tpu.data import loader as jloader
from rdpn6d_tpu.data.assets import load_class_assets as j_assets
from rdpn6d_tpu.data.bop import Split as JSplit
from rdpn6d_tpu.data.bop import build_split_records as j_records
from rdpn6d_tpu.data.bop import register_split as j_register
from rdpn6d_tpu.data.detections import attach_detections as j_attach
from rdpn6d_tpu.data.detections import load_detections as j_load_dets
from rdpn6d_tpu.ops.fps import get_fps_and_center as j_fps
from rdpn6d_tpu_torch.data import inout as tio
from rdpn6d_tpu_torch.data import loader as tloader
from rdpn6d_tpu_torch.data import png
from rdpn6d_tpu_torch.data.assets import cube_points
from rdpn6d_tpu_torch.data.assets import get_fps_and_center as t_fps
from rdpn6d_tpu_torch.data.assets import load_class_assets as t_assets
from rdpn6d_tpu_torch.data.bop import Split as TSplit
from rdpn6d_tpu_torch.data.bop import build_split_records as t_records
from rdpn6d_tpu_torch.data.bop import get_split as t_get_split
from rdpn6d_tpu_torch.data.bop import register_split as t_register
from rdpn6d_tpu_torch.data.detections import attach_detections as t_attach
from rdpn6d_tpu_torch.data.detections import load_detections as t_load_dets
from rdpn6d_tpu_torch.data.synthetic import write_lm_tree
from tests.test_eval_runner import write_cube_ply


def _image(h, w, c, dtype=np.uint8, seed=0):
    """A gradient with noise: the row filters all have work to do."""
    rng = np.random.RandomState(seed)
    top = np.iinfo(dtype).max
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 3 + yy * (k + 1)) % (top + 1)
                     for k in range(c)], -1)
    noise = rng.randint(0, max(top // 50, 3), base.shape)
    img = np.clip(base + noise, 0, top).astype(dtype)
    return img[..., 0] if c == 1 else img


# --- PNG ------------------------------------------------------------------

def test_png_reads_what_cv2_writes(tmp_path):
    rgb = _image(45, 70, 3)
    depth = _image(45, 70, 1, np.uint16, seed=1)
    mask = (_image(45, 70, 1, seed=2) > 128).astype(np.uint8) * 255
    gray = _image(45, 70, 1, seed=3)
    rgba = _image(45, 70, 4, seed=4)
    for name, img in (("rgb", rgb[..., ::-1]), ("depth", depth),
                      ("mask", mask), ("gray", gray),
                      ("rgba", rgba[..., [2, 1, 0, 3]])):
        assert cv2.imwrite(str(tmp_path / f"{name}.png"), img)

    def cv(name, flag):
        return cv2.imread(str(tmp_path / f"{name}.png"), flag)

    np.testing.assert_array_equal(
        png.imread_rgb(str(tmp_path / "rgb.png")),
        cv("rgb", cv2.IMREAD_COLOR)[..., ::-1])
    d = png.imread_unchanged(str(tmp_path / "depth.png"))
    assert d.dtype == np.uint16
    np.testing.assert_array_equal(d, cv("depth", cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(png.imread_mask(str(tmp_path / "mask.png")),
                                  cv("mask", cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(png.imread_rgb(str(tmp_path / "gray.png")),
                                  cv("gray", cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(png.imread_rgb(str(tmp_path / "rgba.png")),
                                  cv("rgba", cv2.IMREAD_COLOR)[..., ::-1])
    # the loader's readers against the JAX package's (cv2) ones
    for fn, args in (("_imread_rgb", ("rgb.png",)),
                     ("_imread_depth", ("depth.png", 1000.0)),
                     ("_imread_mask", ("mask.png",))):
        path = str(tmp_path / args[0])
        np.testing.assert_array_equal(
            getattr(tloader, fn)(path, *args[1:]),
            getattr(jloader, fn)(path, *args[1:]))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png_writer_every_filter_reads_in_cv2(tmp_path, filter_type):
    """The port's writer with each row filter: cv2 decodes it to the
    array written, and so does the port's reader."""
    cases = {"rgb": _image(37, 53, 3), "depth": _image(37, 53, 1, np.uint16),
             "gray_alpha": _image(37, 53, 2), "rgba16":
             _image(37, 53, 4, np.uint16)}
    for name, img in cases.items():
        path = str(tmp_path / f"{name}.png")
        png.write_png(path, img, filter_type)
        np.testing.assert_array_equal(png.read_png(path), img)
        if name != "gray_alpha":   # cv2 keeps BGR(A) order
            want = img[..., [2, 1, 0, 3][:img.shape[-1]]] \
                if img.ndim == 3 else img
            np.testing.assert_array_equal(
                cv2.imread(path, cv2.IMREAD_UNCHANGED), want)
    np.testing.assert_array_equal(
        png.imread_rgb(str(tmp_path / "gray_alpha.png")),
        cv2.imread(str(tmp_path / "gray_alpha.png"), cv2.IMREAD_COLOR))


def test_png_refuses_what_it_does_not_read(tmp_path):
    png.write_png(str(tmp_path / "d16.png"), _image(8, 9, 1, np.uint16))
    png.write_png(str(tmp_path / "rgb.png"), _image(8, 9, 3))
    with pytest.raises(ValueError, match="16-bit"):
        png.imread_rgb(str(tmp_path / "d16.png"))
    for name in ("d16.png", "rgb.png"):
        with pytest.raises(ValueError, match="8-bit gray"):
            png.imread_mask(str(tmp_path / name))
    with pytest.raises(ValueError, match="one-channel"):
        png.imread_unchanged(str(tmp_path / "rgb.png"))
    with pytest.raises(FileNotFoundError):
        png.read_png(str(tmp_path / "missing.png"))
    raw = bytearray(open(tmp_path / "rgb.png", "rb").read())
    (tmp_path / "notpng.png").write_bytes(b"GIF89a" + bytes(raw[6:]))
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(tmp_path / "notpng.png"))
    raw[33 + 8 + 5] ^= 0xFF                  # a byte inside IDAT
    (tmp_path / "crc.png").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(str(tmp_path / "crc.png"))
    ihdr = bytearray(open(tmp_path / "rgb.png", "rb").read())
    ihdr[8 + 8 + 12] = 1                     # interlace method
    body = bytes(ihdr[12:12 + 4 + 13])
    ihdr[8 + 8 + 13:8 + 8 + 17] = struct.pack(">I", zlib.crc32(body))
    (tmp_path / "adam7.png").write_bytes(bytes(ihdr))
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(str(tmp_path / "adam7.png"))


# --- PLY, scene JSON, CSV ----------------------------------------------------

def _write_binary_ply(path, pts, normals, colors, faces):
    head = ["ply", "format binary_little_endian 1.0", "comment test",
            f"element vertex {len(pts)}", "property float x",
            "property float y", "property float z", "property float nx",
            "property float ny", "property float nz", "property uchar red",
            "property uchar green", "property uchar blue",
            f"element face {len(faces)}",
            "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        for p, n, c in zip(pts, normals, colors):
            f.write(struct.pack("<6f3B", *p, *n, *c))
        for face in faces:
            f.write(struct.pack("<B", len(face)))
            f.write(struct.pack(f"<{len(face)}i", *face))


def test_load_ply_ascii_and_binary(tmp_path):
    write_cube_ply(str(tmp_path / "cube.ply"))
    rng = np.random.RandomState(0)
    pts = rng.randn(50, 3).astype(np.float32) * 30
    _write_binary_ply(str(tmp_path / "bin.ply"), pts,
                      rng.randn(50, 3).astype(np.float32),
                      rng.randint(0, 255, (50, 3)),
                      [(0, 1, 2), (3, 4, 5, 6), (7, 8, 9)])
    for name in ("cube.ply", "bin.ply"):
        j = jio.load_ply(str(tmp_path / name), vertex_scale=0.001)
        t = tio.load_ply(str(tmp_path / name), vertex_scale=0.001)
        assert sorted(j) == sorted(t)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
            assert t[k].dtype == j[k].dtype


@pytest.fixture(scope="module")
def lm_tree(tmp_path_factory):
    """The port's LM tree of two objects plus a cv2-written scene of the
    test_eval_runner layout (rgb/depth/mask by OpenCV, cube PLY with
    faces), one scene with two instances of one image and a symmetric
    object with a precomputed fps_points.pkl."""
    root = str(tmp_path_factory.mktemp("io_tree"))
    write_lm_tree(root, {"ape": 1, "can": 5}, frames_per_obj=2, seed=1)
    ds = os.path.join(root, "lm")
    sdir = os.path.join(ds, "test", "000008")
    for sub in ("rgb", "depth", "mask_visib"):
        os.makedirs(os.path.join(sdir, sub))
    write_cube_ply(os.path.join(ds, "models", "obj_000008.ply"))
    K = [572.4, 0, 325.3, 0, 573.6, 242.0, 0, 0, 1]
    gt, cam, info = {}, {}, {}
    for im_id in range(2):
        img = _image(480, 640, 3, seed=im_id)
        cv2.imwrite(os.path.join(sdir, "rgb", f"{im_id:06d}.png"), img)
        cv2.imwrite(os.path.join(sdir, "depth", f"{im_id:06d}.png"),
                    _image(480, 640, 1, np.uint16, seed=im_id))
        gt[str(im_id)] = [{"cam_R_m2c": np.eye(3).ravel().tolist(),
                           "cam_t_m2c": [10.0 * k, 0.0, 700.0],
                           "obj_id": 8} for k in range(2)]
        cam[str(im_id)] = {"cam_K": K, "depth_scale": 0.1}
        info[str(im_id)] = [{"bbox_visib": [100 + 40 * k, 90, 60, 70],
                             "visib_fract": 0.5} for k in range(2)]
        for k in range(2):
            cv2.imwrite(os.path.join(sdir, "mask_visib",
                                     f"{im_id:06d}_{k:06d}.png"),
                        (img[..., 0] > 100).astype(np.uint8) * 255)
    for name, d in (("scene_gt.json", gt), ("scene_camera.json", cam),
                    ("scene_gt_info.json", info)):
        with open(os.path.join(sdir, name), "w") as f:
            json.dump(d, f)
    for sub in ("models", "models_eval"):
        mi_path = os.path.join(ds, sub, "models_info.json")
        mi = json.load(open(mi_path))
        mi["8"] = {"diameter": 173.2, "size_x": 100.0, "size_y": 100.0,
                   "size_z": 100.0, "symmetries_discrete": [
                       [-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 4.0,
                        0, 0, 0, 1]],
                   "symmetries_continuous": [{"axis": [0, 0, 1],
                                              "offset": [0, 0, 2.0]}]}
        json.dump(mi, open(mi_path, "w"))
    os.symlink(os.path.join(ds, "models", "obj_000008.ply"),
               os.path.join(ds, "models_eval", "obj_000008.ply"))
    with open(os.path.join(ds, "image_set", "driller_test.txt"), "w") as f:
        f.write("0\n1\n")
    for cls, reg in ((JSplit, j_register), (TSplit, t_register)):
        reg(cls("io_three", "lm", "test", objs=("ape", "can", "driller"),
                per_obj_index="image_set/{obj}_test.txt"))
        reg(cls("io_scene8", "lm", "test", scene_ids=(8,),
                filter_invalid=False))
    return root


def test_scene_json_and_csv(lm_tree, tmp_path):
    sdir = os.path.join(lm_tree, "lm", "test", "000008")
    for fn in ("load_scene_gt", "load_scene_camera", "load_scene_gt_info"):
        name = {"load_scene_gt": "scene_gt.json",
                "load_scene_camera": "scene_camera.json",
                "load_scene_gt_info": "scene_gt_info.json"}[fn]
        j = getattr(jio, fn)(os.path.join(sdir, name))
        t = getattr(tio, fn)(os.path.join(sdir, name))
        _assert_same(t, j)
    rng = np.random.RandomState(2)
    rows = [{"scene_id": int(rng.randint(50)), "im_id": int(rng.randint(999)),
             "obj_id": int(rng.randint(1, 16)), "score": float(rng.rand()),
             "R": rng.randn(3, 3).astype(np.float32),
             "t": rng.randn(3).astype(np.float32),
             "time": float(rng.rand())} for _ in range(7)]
    jio.save_bop_results_csv(str(tmp_path / "j.csv"), rows)
    tio.save_bop_results_csv(str(tmp_path / "t.csv"), rows)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv") \
        .read_bytes()
    _assert_same(tio.load_bop_results_csv(str(tmp_path / "t.csv")),
                 jio.load_bop_results_csv(str(tmp_path / "j.csv")))


def _assert_same(t, j):
    """Equal nested containers; arrays equal with the same dtype."""
    assert type(t) is type(j)
    if isinstance(j, dict):
        assert list(t) == list(j)
        for k in j:
            _assert_same(t[k], j[k])
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _assert_same(a, b)
    elif isinstance(j, np.ndarray):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)
    else:
        assert t == j


# --- records, detections, assets ----------------------------------------------

@pytest.mark.parametrize("split", ["io_three", "io_scene8"])
@pytest.mark.parametrize("flatten", [True, False])
def test_build_split_records_match_jax(lm_tree, monkeypatch, tmp_path,
                                       split, flatten):
    monkeypatch.setattr(jrefs, "DATA_ROOT", lm_tree)
    monkeypatch.setattr(trefs, "DATA_ROOT", lm_tree)
    from rdpn6d_tpu.data.bop import get_split as j_get_split

    j = j_records(j_get_split(split), flatten=flatten)
    t = t_records(t_get_split(split), cache_dir=str(tmp_path),
                  flatten=flatten)
    assert len(t) > 0
    _assert_same(t, j)
    # the cached copy is what the next call serves
    _assert_same(t_records(t_get_split(split), cache_dir=str(tmp_path),
                           flatten=flatten), j)


def test_lm13_split_and_non_bop_layouts(lm_tree, monkeypatch, tmp_path):
    monkeypatch.setattr(trefs, "DATA_ROOT", lm_tree)
    split = t_get_split("lm_13_test")
    assert split.per_obj_index == "image_set/{obj}_test.txt"
    assert len(split.objs) == 13 and "bowl" not in split.objs
    # the ycb_style layout, once refused, builds the JAX package's records
    from rdpn6d_tpu.data.bop import get_split as j_get_split
    from rdpn6d_tpu_torch.data.synthetic import write_mp6d_tree

    write_mp6d_tree(str(tmp_path), train_frames=1, test_frames=1,
                    insts_per_frame=2, seed=2)
    monkeypatch.setattr(trefs, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(jrefs, "DATA_ROOT", str(tmp_path))
    for flatten in (True, False):
        t = t_records(t_get_split("mp6d_test"), flatten=flatten)
        assert len(t) == (2 if flatten else 1)
        _assert_same(t, j_records(j_get_split("mp6d_test"), flatten=flatten))


def test_detections_match_jax(lm_tree, monkeypatch, tmp_path):
    monkeypatch.setattr(jrefs, "DATA_ROOT", lm_tree)
    monkeypatch.setattr(trefs, "DATA_ROOT", lm_tree)
    records = t_records(t_get_split("io_scene8"))
    dets = [{"scene_id": 8, "im_id": 0, "obj_id": 8, "score": 0.9,
             "bbox_est": [140, 92, 58, 66]},
            {"scene_id": 8, "im_id": 0, "obj_id": 8, "score": 0.7,
             "bbox_est": [101, 88, 61, 69]},
            {"scene_id": 8, "im_id": 0, "obj_id": 8, "score": 0.2,
             "bbox_est": [300, 300, 20, 20]},
            {"scene_im_id": "8/1", "obj_id": 8, "score": 0.5,
             "bbox": [100, 90, 60, 70], "time": 0.25}]
    as_dict = {"8/0": dets[:3], "8/1": [dict(dets[3], scene_im_id=None)]}
    for i, payload in enumerate((dets, as_dict)):
        path = str(tmp_path / f"dets{i}.json")
        with open(path, "w") as f:
            json.dump(payload, f)
        j, t = j_load_dets(path), t_load_dets(path)
        _assert_same(dict(t), dict(j))
        for topk in (1, 2, 3):
            _assert_same(t_attach(records, t, topk_per_obj=topk),
                         j_attach(records, j, topk_per_obj=topk))


@pytest.mark.parametrize("eval_models", [False, True])
def test_load_class_assets_match_jax(lm_tree, monkeypatch, eval_models):
    monkeypatch.setattr(jrefs, "DATA_ROOT", lm_tree)
    monkeypatch.setattr(trefs, "DATA_ROOT", lm_tree)
    kw = dict(num_regions=8, num_pm_points=300,
              objs=["ape", "can", "driller"], use_eval_models=eval_models)
    j = j_assets(jrefs.get_ref("lm"), **kw)
    t = t_assets(trefs.get_ref("lm"), **kw)
    assert t.obj_ids == j.obj_ids and t.full_cls_idx == j.full_cls_idx
    for k in ("points", "extents", "fps_points", "diameters"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    assert t.sym_rots.shape == j.sym_rots.shape and t.sym_rots.shape[1] > 300
    np.testing.assert_allclose(t.sym_rots, j.sym_rots, rtol=0, atol=1e-7)
    np.testing.assert_allclose(t.sym_trans, j.sym_trans, rtol=0, atol=1e-7)


def test_fps_points_pkl_is_honoured(lm_tree, monkeypatch, tmp_path):
    models = tmp_path / "lm" / "models"
    os.makedirs(models)
    for f in ("models_info.json", "obj_000001.ply"):
        os.symlink(os.path.join(lm_tree, "lm", "models", f), models / f)
    fixed = np.arange(3 * 9, dtype=np.float32).reshape(9, 3) / 100
    with open(models / "fps_points.pkl", "wb") as f:
        # the pickle covers every object of the ref, as tools write it
        pickle.dump({str(i): {"fps8_and_center": fixed + i}
                     for i in range(1, 16)}, f)
    monkeypatch.setattr(jrefs, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(trefs, "DATA_ROOT", str(tmp_path))
    kw = dict(num_regions=8, num_pm_points=50, objs=["ape"])
    t = t_assets(trefs.get_ref("lm"), **kw)
    np.testing.assert_array_equal(t.fps_points[0], fixed[:8] + 1)
    np.testing.assert_array_equal(
        t.fps_points, j_assets(jrefs.get_ref("lm"), **kw).fps_points)


@pytest.mark.parametrize("cloud", ["seeded_5000", "cube", "grid"])
@pytest.mark.parametrize("k", [8, 32, 64])
def test_fps_matches_native_backend(cloud, k):
    """Index for index against the JAX package's default backend (the
    native float32 loop); float64 FPS picks other keypoints at the ties
    of the cube and the grid."""
    pts = {"seeded_5000": np.random.RandomState(0).randn(5000, 3)
           .astype(np.float32) * 0.05,
           "cube": cube_points(),
           "grid": np.stack(np.meshgrid(*[np.linspace(-0.1, 0.1, 13)] * 3),
                            -1).reshape(-1, 3).astype(np.float32)}[cloud]
    np.testing.assert_array_equal(t_fps(pts, k), j_fps(pts, k))


@pytest.mark.parametrize("cache_mb", [0, 64])
def test_record_decoder_matches_jax(lm_tree, monkeypatch, tmp_path, cache_mb):
    """``read_frame`` and ``_mask_visib`` (mask file, label image, neither)
    against the JAX package's decoder, with and without the frame LRU."""
    from rdpn6d_tpu.config import Config as JConfig
    from rdpn6d_tpu.data.assets import synthetic_class_assets
    from rdpn6d_tpu_torch.config import Config as TConfig

    monkeypatch.setattr(trefs, "DATA_ROOT", lm_tree)
    opts = [f"data.frame_cache_mb={cache_mb}"]
    j = jloader.RecordDecoder(JConfig().apply_opts(opts),
                              synthetic_class_assets(), train=False)
    t = tloader.RecordDecoder(TConfig().apply_opts(opts))
    label = _image(480, 640, 1, seed=9) % 4
    cv2.imwrite(str(tmp_path / "label.png"), label)
    recs = t_records(t_get_split("io_scene8"))
    for rec in recs + [t_records(t_get_split("io_three"))[0]]:
        _assert_same(t.read_frame(rec), j.read_frame(rec))
        for extra in ({}, {"mask_visib_path": str(tmp_path / "none.png"),
                           "label_path": str(tmp_path / "label.png"),
                           "label_obj_id": 2},
                      {"mask_visib_path": "", "label_path": ""}):
            r = {**rec, **extra}
            _assert_same(t._mask_visib(r), j._mask_visib(r))
    # the train decode is in, background replacement too (held to the JAX
    # package in test_torch_train_data.py); the flat path's decode, once
    # refused, gives the JAX package's sample (its bg branch is held in
    # test_torch_layouts.py; without a pool no background replaces)
    from rdpn6d_tpu_torch.data.assets import synthetic_class_assets as t_syn

    bg_opts = opts + ["data.change_bg_prob=0.5", "head.num_regions=4"]
    ta, ja = t_syn(4, 64), synthetic_class_assets(4, 64)
    ta.obj_ids[:] = ja.obj_ids[:] = [recs[0]["obj_id"]]
    bg = tloader.RecordDecoder(TConfig().apply_opts(bg_opts), ta,
                               train=True)
    jbg = jloader.RecordDecoder(JConfig().apply_opts(bg_opts), ja,
                                num_pm_points=64, train=True)
    _assert_same(bg(recs[0]), jbg(recs[0]))
