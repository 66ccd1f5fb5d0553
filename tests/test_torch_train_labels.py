"""Train-mode labels: the port's region labels, rotated FPS residuals and
the train half of ROI preprocessing against the JAX package.

Inputs come from numpy seeds; the DZI draws are the JAX side's (its
``bbox_center`` / ``scale`` outputs are injected as ``center_scale``), and
colour augmentation is off. Tolerances:

* region ids agree on >= 0.999 of the pixels: the JAX side forms
  |x|^2 - 2 x.f + |f|^2, the port the direct sum of squares, so a pixel
  whose two nearest keypoints are closer than the rounding may flip;
* coordinates agree to 1e-5 wherever the ids agree, background included
  (both are float32 products of values ~0.1 divided by extents ~0.1);
* the nearest crops of masks and xyz are gathers on both sides (a one-hot
  matmul at "highest" is exact on the JAX side): masks exactly;
* the bilinear crops (roi_img, roi_coord_2d) to 5e-5: XLA contracts a
  source coordinate's ``center + grid * r`` into an FMA, torch does not,
  so a tap may sit an ulp (<= 1.5e-5 px below 256) away; the fixture's
  noise image changes by up to 1 (normalized) per pixel, and its depth by
  ~1.4 (metres / resize_ratio) across a cube's silhouette, along each of
  two axes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.data.pipeline import dzi_jitter as j_dzi
from rdpn6d_tpu.data.pipeline import preprocess_rois_grouped as j_grouped
from rdpn6d_tpu.data.synthetic import dummy_grouped_inputs as j_grouped_in
from rdpn6d_tpu.data.synthetic import dummy_train_batch as j_dummy_batch
from rdpn6d_tpu.geometry import ego_to_allo_mat as j_ego_to_allo
from rdpn6d_tpu.geometry import mat_to_ortho6d as j_mat_to_ortho6d
from rdpn6d_tpu.ops.binning import quantize_coords as j_quantize
from rdpn6d_tpu.ops.region import residual_coord_target as j_residual
from rdpn6d_tpu.ops.region import xyz_to_region as j_xyz_to_region
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data import synthetic as tsyn
from rdpn6d_tpu_torch.data.pipeline import dzi_jitter as t_dzi
from rdpn6d_tpu_torch.data.pipeline import preprocess_roi as t_roi
from rdpn6d_tpu_torch.data.pipeline import preprocess_rois_grouped as t_grouped
from rdpn6d_tpu_torch.geometry import ego_to_allo_mat, mat_to_ortho6d
from rdpn6d_tpu_torch.ops import cuda_build
from rdpn6d_tpu_torch.ops.binning import quantize_coords
from rdpn6d_tpu_torch.ops.region import (
    region_label,
    residual_coord_target,
    xyz_to_region,
)

ID_AGREE = 0.999
COORD_TOL = 1e-5
TINY = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rotations(rng, n):
    q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    return (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)


def label_inputs(B=3, H=24, W=20, K=32, seed=0):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-0.06, 0.06, (B, H, W, 3)).astype(np.float32)
    xyz[rng.rand(B, H, W) < 0.3] = 0.0                  # background
    fps = rng.uniform(-0.05, 0.05, (B, K, 3)).astype(np.float32)
    ext = rng.uniform(0.05, 0.2, (B, 3)).astype(np.float32)
    return xyz, fps, _rotations(rng, B), ext


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("K", [1, 5, 32, 64])
def test_residual_coord_target_matches_jax(K):
    xyz, fps, R, ext = label_inputs(K=K, seed=K)
    j_reg, j_coord = (np.asarray(a) for a in j_residual(
        *map(jnp.asarray, (xyz, fps, R, ext))))
    cuda_build.reset_launches()
    reg, coord = residual_coord_target(*_t(xyz, fps, R, ext))
    assert reg.dtype == torch.int32 and coord.dtype == torch.float32
    assert cuda_build.LAUNCHES.get("region_label", 0) == 0   # plain on CPU
    reg, coord = reg.numpy(), coord.numpy()
    same = reg == j_reg
    assert same.mean() >= ID_AGREE
    np.testing.assert_array_equal(reg == 0, np.all(xyz == 0, -1))
    bg = reg == 0
    assert bg.any() and (bg & same).sum() == bg.sum()
    np.testing.assert_allclose(coord[same], j_coord[same], rtol=0,
                               atol=COORD_TOL)


def test_xyz_to_region_matches_jax():
    xyz, fps, _, _ = label_inputs(K=8, seed=3)
    j_reg, j_delta = (np.asarray(a) for a in j_xyz_to_region(
        jnp.asarray(xyz), jnp.asarray(fps)))
    reg, delta = (a.numpy() for a in xyz_to_region(*_t(xyz, fps)))
    same = reg == j_reg
    assert same.mean() >= ID_AGREE
    np.testing.assert_allclose(delta[same], j_delta[same], rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("K", [96, 200])
def test_many_keypoints_match_jax(K):
    """Past the kernel's 64-keypoint shared-memory tile: region ids equal
    to the JAX package's ``xyz_to_region`` and ``residual_coord_target``
    at every pixel of these inputs, coordinates within COORD_TOL and raw
    residuals within 1e-7 (float32 differences of values ~0.1)."""
    xyz, fps, R, ext = label_inputs(K=K, seed=K)
    j_reg, j_delta = (np.asarray(a) for a in j_xyz_to_region(
        jnp.asarray(xyz), jnp.asarray(fps)))
    j_reg2, j_coord = (np.asarray(a) for a in j_residual(
        *map(jnp.asarray, (xyz, fps, R, ext))))
    reg, delta = (a.numpy() for a in xyz_to_region(*_t(xyz, fps)))
    np.testing.assert_array_equal(reg, j_reg)
    np.testing.assert_allclose(delta, j_delta, rtol=0, atol=1e-7)
    reg, coord = (a.numpy() for a in region_label(*_t(xyz, fps, R, ext)))
    np.testing.assert_array_equal(reg, j_reg2)
    assert reg.max() > 64, "a pixel lands past the first tile"
    np.testing.assert_allclose(coord, j_coord, rtol=0, atol=COORD_TOL)


def test_tie_across_the_keypoint_tile_goes_to_the_lower_index():
    """Two keypoints equidistant from a pixel, one each side of the
    kernel's 64-keypoint tile boundary (63 and 64) and farther apart (5
    and 130): the lower index wins, as in JAX's argmin."""
    K = 131
    fps = np.full((1, K, 3), -1.0, np.float32)
    fps[0, :, 2] -= np.arange(K, dtype=np.float32) * 0.01   # all far away
    fps[0, 63], fps[0, 64] = (0.1, 0.0, 0.0), (-0.1, 0.0, 0.0)
    fps[0, 5], fps[0, 130] = (0.0, 0.05, 0.6), (0.0, -0.05, 0.6)
    xyz = np.zeros((1, 1, 2, 3), np.float32)
    xyz[0, 0, 0] = (0.0, 0.0, -0.3)                    # ties 63 and 64
    xyz[0, 0, 1] = (0.0, 0.0, 0.6)                     # ties 5 and 130
    R, ext = np.eye(3, dtype=np.float32)[None], np.ones((1, 3), np.float32)
    reg, _ = region_label(*_t(xyz, fps, R, ext))
    assert reg[0, 0].tolist() == [64, 6]
    j_reg, _ = j_xyz_to_region(jnp.asarray(xyz), jnp.asarray(fps))
    assert np.asarray(j_reg)[0, 0].tolist() == [64, 6]


def test_region_label_ties_and_background():
    """Equidistant keypoints go to the lowest index; a background pixel
    takes the keypoint nearest the origin for its coordinate."""
    fps = torch.tensor([[[0.1, 0.0, 0.0], [-0.1, 0.0, 0.0],
                         [0.0, 0.05, 0.0], [0.0, -0.05, 0.0]]])
    xyz = torch.zeros(1, 1, 3, 3)
    xyz[0, 0, 1] = torch.tensor([0.0, 0.0, 0.3])   # ties fps 2 and 3
    xyz[0, 0, 2] = torch.tensor([0.2, 0.0, 0.0])   # nearest fps 0
    R = torch.eye(3)[None]
    ext = torch.full((1, 3), 0.5)
    reg, coord = region_label(xyz, fps, R, ext)
    assert reg[0, 0].tolist() == [0, 3, 1]
    torch.testing.assert_close(coord[0, 0, 0], (-fps[0, 2]) / 0.5 + 0.5)
    torch.testing.assert_close(coord[0, 0, 2], (xyz[0, 0, 2] - fps[0, 0])
                               / 0.5 + 0.5)


def test_region_label_refuses_bad_input():
    xyz, fps, R, ext = _t(*label_inputs(B=2, K=4))
    with pytest.raises(TypeError):
        region_label(xyz.double(), fps, R, ext)
    with pytest.raises(ValueError):
        region_label(xyz, fps[:1], R, ext)
    with pytest.raises(ValueError):
        region_label(xyz, fps[:, :0], R, ext)
    with pytest.raises(ValueError):
        region_label(xyz.to("meta"), fps, R, ext)


def test_quantize_and_pose_targets_match_jax():
    rng = np.random.RandomState(4)
    coord = rng.uniform(-0.1, 1.1, (2, 8, 8, 3)).astype(np.float32)
    mask = (rng.rand(2, 8, 8) > 0.4).astype(np.float32)
    np.testing.assert_array_equal(
        quantize_coords(*_t(coord, mask), 64).numpy(),
        np.asarray(j_quantize(jnp.asarray(coord), jnp.asarray(mask), 64)))
    R = _rotations(rng, 5)
    t = np.concatenate([rng.uniform(-0.2, 0.2, (5, 2)),
                        rng.uniform(0.4, 1.5, (5, 1))], 1).astype(np.float32)
    ours = mat_to_ortho6d(ego_to_allo_mat(*_t(t, R))).numpy()
    ref = np.asarray(j_mat_to_ortho6d(j_ego_to_allo(jnp.asarray(t),
                                                    jnp.asarray(R))))
    np.testing.assert_allclose(ours, ref, atol=1e-6)


@pytest.mark.parametrize("kind", ["uniform", "roi10d"])
def test_dzi_jitter_draws(kind):
    """The port's draws are its own; the boxes follow the JAX package's
    formulas: recompute them from the same generator's draws."""
    rng = np.random.RandomState(5)
    xy = rng.uniform(0, 400, (64, 2))
    bbox = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(5, 150, (64, 2))], 1).astype(np.float32))
    g = torch.Generator().manual_seed(1)
    c, s = t_dzi(bbox, (480, 640), kind, enable=True, generator=g)
    g = torch.Generator().manual_seed(1)
    r = torch.rand((64, 3 if kind == "uniform" else 4), generator=g)
    x1, y1, x2, y2 = bbox.unbind(-1)
    bw, bh = x2 - x1, y2 - y1
    if kind == "uniform":
        r = 2 * r - 1
        c_ref = torch.stack([(x1 + x2) / 2 + bw * 0.25 * r[:, 1],
                             (y1 + y2) / 2 + bh * 0.25 * r[:, 2]], -1)
        s_ref = torch.maximum(bw, bh) * (1 + 0.25 * r[:, 0]) * 1.5
    else:
        r = -0.15 + 0.3 * r
        nx1 = (x1 + bw * r[:, 0]).clamp(0, 640)
        nx2 = (x2 + bw * r[:, 1]).clamp(0, 640)
        ny1 = (y1 + bh * r[:, 2]).clamp(0, 480)
        ny2 = (y2 + bh * r[:, 3]).clamp(0, 480)
        c_ref = torch.stack([(nx1 + nx2) / 2, (ny1 + ny2) / 2], -1)
        s_ref = torch.maximum(nx2 - nx1, ny2 - ny1) * 1.5
    torch.testing.assert_close(c, c_ref)
    torch.testing.assert_close(s, s_ref.clamp(1, 640))
    # disabled: the JAX package's test-time box
    jc, js = jax.vmap(lambda b: j_dzi(jax.random.PRNGKey(0), b, (480, 640),
                                      enable=False))(jnp.asarray(bbox))
    c0, s0 = t_dzi(bbox, (480, 640), kind, enable=False)
    np.testing.assert_allclose(c0.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(s0.numpy(), np.asarray(js), rtol=1e-6)


def test_synthetic_fixtures_match_jax():
    cfg_t, cfg_j = TConfig().apply_opts(TINY), JConfig().apply_opts(TINY)
    f_t, r_t = tsyn.dummy_grouped_inputs(cfg_t, seed=3)
    f_j, r_j = j_grouped_in(cfg_j, seed=3)
    assert set(f_t) == set(f_j) and set(r_t) == set(r_j)
    for a, b in [(f_t, f_j), (r_t, r_j)]:
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    bt = tsyn.dummy_train_batch(cfg_t, 3, seed=2)
    bj = j_dummy_batch(cfg_j, 3, seed=2)
    assert set(bt) == set(bj)
    for k in bt:
        np.testing.assert_allclose(bt[k], np.asarray(bj[k]), atol=1e-7,
                                   err_msg=k)


def _crop_to_object(rois):
    """Ship each ROI's GT as the crop around its xyz map's nonzero box
    (+ a margin), with xyz_offset = the crop's top-left pixel."""
    out = {k: [] for k in ("xyz", "mask_packed", "xyz_offset")}
    h = max(int(np.ptp(np.nonzero(np.any(x != 0, -1))[0])) for x in
            rois["xyz"]) + 7
    w = max(int(np.ptp(np.nonzero(np.any(x != 0, -1))[1])) for x in
            rois["xyz"]) + 7
    for xyz, packed in zip(rois["xyz"], rois["mask_packed"]):
        ys, xs = np.nonzero(np.any(xyz != 0, -1))
        y0, x0 = max(ys.min() - 3, 0), max(xs.min() - 3, 0)
        crop = np.zeros((h, w, 3), xyz.dtype)
        mcrop = np.zeros((h, w), packed.dtype)
        src = xyz[y0:y0 + h, x0:x0 + w]
        crop[:src.shape[0], :src.shape[1]] = src
        mcrop[:src.shape[0], :src.shape[1]] = packed[y0:y0 + h, x0:x0 + w]
        out["xyz"].append(crop)
        out["mask_packed"].append(mcrop)
        out["xyz_offset"].append(np.array([x0, y0], np.float32))
    return {k: np.stack(v) for k, v in out.items()}


CASES = {
    # xyz shipped, unpacked visib + trunc masks, RDPN residual coords
    "xyz": ([], "unpacked"),
    # xyz shipped, GDR-Net absolute coords, CE_coor bins on the obj mask
    "xyz_absolute_ce": (["head.coord_residual=false",
                         'head.xyz_loss="CE_coor"', "head.xyz_bin=16",
                         'head.xyz_loss_mask="obj"'], "unpacked"),
    # no xyz: coords from the depth surface, packed masks, roi10d boxes
    "depth_fallback": (['data.dzi_type="roi10d"'], "depth"),
    # packed masks + xyz shipped as object crops with their offsets
    "packed_xyz_offset": ([], "offset"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_preprocessing_matches_jax(case):
    opts, kind = CASES[case]
    opts = TINY + opts
    cfg_t, cfg_j = TConfig().apply_opts(opts), JConfig().apply_opts(opts)
    frames, rois = tsyn.dummy_grouped_inputs(
        cfg_t, n_frames=2, rois_per_frame=3, seed=7,
        ship_xyz=kind != "depth")
    rois = dict(rois)
    if kind == "unpacked":
        packed = rois.pop("mask_packed")
        rois["mask_visib"] = (packed & 1).astype(np.float32)
        trunc = (packed >> 1) & 1
        trunc[:, :, ::7] = 0                  # trunc differs from visib
        rois["mask_trunc"] = trunc.astype(np.float32)
    elif kind == "offset":
        rois.update(_crop_to_object(rois))
    ref = j_grouped(cfg_j, {k: jnp.asarray(v) for k, v in frames.items()},
                    {k: jnp.asarray(v) for k, v in rois.items()},
                    jax.random.PRNGKey(11), train=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    ours = t_grouped(
        cfg_t, {k: torch.from_numpy(v) for k, v in frames.items()},
        {k: torch.from_numpy(v) for k, v in rois.items()}, train=True,
        center_scale=(torch.tensor(ref["bbox_center"]),
                      torch.tensor(ref["scale"])))
    ours = {k: v.numpy() for k, v in ours.items()}
    assert set(ours) == set(ref)
    for k in ("roi_mask_visib", "roi_mask_obj", "roi_mask_trunc",
              "roi_cls", "roi_points", "sym_rots", "gt_rot", "gt_trans"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    fg = ref["roi_mask_visib"] > 0
    assert fg.mean() > 0.05, "the crops should hold the objects"
    same = ours["roi_region"] == ref["roi_region"]
    assert same.mean() >= ID_AGREE
    np.testing.assert_allclose(ours["roi_xyz"][same], ref["roi_xyz"][same],
                               rtol=0, atol=COORD_TOL)
    for k, tol in (("roi_img", 5e-5), ("roi_coord_2d", 5e-5),
                   ("trans_ratio", 1e-5), ("gt_allo_rot6d", 1e-6),
                   ("resize_ratio", 1e-7), ("roi_cam", 0)):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, atol=tol,
                                   err_msg=k)
    if "roi_xyz_bin" in ref:
        assert (ours["roi_xyz_bin"] == ref["roi_xyz_bin"]).mean() >= ID_AGREE


def test_train_preprocessing_refusals():
    cfg = TConfig().apply_opts(TINY)
    frames, rois = tsyn.dummy_grouped_inputs(cfg, n_frames=1,
                                             rois_per_frame=2)
    frames = {k: torch.from_numpy(v) for k, v in frames.items()}
    rois = {k: torch.from_numpy(v) for k, v in rois.items()}
    with pytest.raises(ValueError, match="frame axis"):
        t_grouped(cfg, {**frames, "mask_visib": frames["depth"]}, rois,
                  train=True)
    with pytest.raises(NotImplementedError):
        t_grouped(cfg.apply_opts(["data.color_aug_prob=0.5"]), frames, rois,
                  train=True)
    with pytest.raises(NotImplementedError):
        t_grouped(cfg.apply_opts(['data.dzi_type="truncnorm"']), frames,
                  rois, train=True)
    # one ROI through preprocess_roi, box given
    sample = {k: v[0] for k, v in rois.items() if k != "frame_idx"}
    sample.update({k: frames[k][0] for k in ("rgb", "depth", "K")})
    one = t_roi(cfg, sample, train=True,
                center_scale=(torch.tensor([80.0, 60.0]),
                              torch.tensor(40.0)))
    assert one["roi_region"].shape == (16, 16)
    assert one["bbox_center"].tolist() == [80.0, 60.0]
