"""The depth-surface train labels (``ops/surface_labels.surface_labels``,
its plain version on the CPU) against the JAX package's grouped train
preprocessing without GT xyz maps (``rdpn6d_tpu/data/pipeline.py``: the
stacked nearest ``crop_resize_mm`` of [visib, depth, u, v(, trunc)] at
precision="highest", the back-projection, R^T (p - t), then
``residual_coord_target``, or ``xyz_to_region`` and xyz / extent + 0.5 in
absolute mode).

Inputs are ``data/synthetic.dummy_grouped_inputs(..., ship_xyz=False)``
from numpy seeds (cube scenes, packed masks), edited per case. The JAX
side draws no DZI jitter (``data.dzi_type="none"``, pad 1), so each ROI's
crop is its box's centre and side; its ``bbox_center`` and ``scale`` go to
the port as they are. Tolerances, as in test_torch_train_labels:

* masks exactly: both sides take the same taps (a one-hot matmul at
  "highest" reproduces the gather bit for bit) of 0/1 products;
* region ids on >= 0.999 of the pixels: the JAX side forms
  |x|^2 - 2 x.f + |f|^2, the port the direct sum of squares, so a pixel
  whose two nearest keypoints are closer than the rounding may flip;
* coordinates to 1e-5 wherever the ids agree: float32 products of values
  ~0.1 divided by extents ~0.1, summed in another order. A background
  pixel's id is 0 on both sides, but its coordinate comes from the
  keypoint nearest the origin, and the cube's FPS keypoints hold near-ties
  there too (pairs at equal distance up to float32 rounding): where the
  two sides pick different keypoints of such a pair (float64 decides
  that it is one), that ROI's background is a flip like the ids'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.data.pipeline import preprocess_rois_grouped as j_grouped
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data import pipeline
from rdpn6d_tpu_torch.data import synthetic as tsyn
from rdpn6d_tpu_torch.ops import cuda_build
from rdpn6d_tpu_torch.ops.region import xyz_to_region
from rdpn6d_tpu_torch.ops.surface_labels import surface_labels
from rdpn6d_tpu_torch.ops.warp import crop_resize_frames

ID_AGREE = 0.999
COORD_TOL = 1e-5
MASK_KEYS = ("roi_mask_visib", "roi_mask_obj", "roi_mask_trunc")
OUT = 16
TINY = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_filters=32", "data.input_res=64", "data.out_res=16",
        'data.dzi_type="none"', "data.dzi_pad_scale=1.0"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _box(center, side):
    """The xyxy box whose undrawn DZI crop is (center, side)."""
    cx, cy = center
    return np.array([cx - side / 2, cy - side / 2, cx + side / 2,
                     cy + side / 2], np.float32)


def scene(K=32, masks="packed", seed=0, edges=True):
    """2 frames of 3 cubes (120x160, focal 140), 6 ROIs, no xyz maps.
    Depth holes inside the objects (zero-depth pixels under the mask), a
    trunc mask that differs from visib; with ``edges``, ROI 0's crop runs
    off the frame's top-left, ROI 1's off its right edge, ROI 2's taps sit
    on exact half pixels (integer centre, side out / 2) and ROI 5's crop
    is larger than the frame. K > 32 takes seeded keypoints in the cube.
    ``masks``: "packed" (uint8 bits), "trunc" (float32 visib and trunc)
    or "visib_only"."""
    cfg = TConfig().apply_opts(TINY + [f"head.num_regions={min(K, 32)}"])
    frames, rois = tsyn.dummy_grouped_inputs(cfg, n_frames=2,
                                             rois_per_frame=3, seed=seed)
    rng = np.random.RandomState(seed + 100)
    frames["depth"] = np.where(rng.rand(*frames["depth"].shape) < 0.05,
                               np.float32(0.0), frames["depth"])
    packed = rois["mask_packed"].copy()
    packed[:, :, ::5] &= 1                  # trunc differs from visib
    if K > 32:
        B = packed.shape[0]
        rois["fps"] = rng.uniform(-0.05, 0.05, (B, K, 3)).astype(np.float32)
    if edges:
        H, W = frames["depth"].shape[1:]
        for b, (c, s) in {0: ((3.0, 5.0), 40.0), 1: ((W - 2.5, 60.0), 48.0),
                          2: (tuple(np.round(rois["bbox"][2, :2]
                                             + 10.0)), OUT / 2),
                          5: ((W / 2, H / 2), 1.5 * W)}.items():
            rois["bbox"][b] = _box(c, s)
    if masks == "packed":
        rois["mask_packed"] = packed
    else:
        del rois["mask_packed"]
        rois["mask_visib"] = (packed & 1).astype(np.float32)
        if masks == "trunc":
            rois["mask_trunc"] = ((packed >> 1) & 1).astype(np.float32)
    return frames, rois


def jax_labels(frames, rois, residual=True):
    """The JAX package's grouped train preprocessing (no xyz maps)."""
    cfg = JConfig().apply_opts(
        TINY + [f"head.num_regions={rois['fps'].shape[1]}",
                f"head.coord_residual={str(residual).lower()}"])
    out = j_grouped(cfg, {k: jnp.asarray(v) for k, v in frames.items()},
                    {k: jnp.asarray(v) for k, v in rois.items()},
                    jax.random.PRNGKey(0), train=True)
    return {k: np.array(v) for k, v in out.items()}


def port_labels(frames, rois, center, scale, residual=True):
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in {**frames, **rois}.items()}
    fidx = t["frame_idx"].long()
    mask = t["mask_packed"] if "mask_packed" in t else t["mask_visib"]
    cam = torch.from_numpy(frames["K"])[fidx]
    out = surface_labels(t["depth"], fidx, mask, t.get("mask_trunc"), cam,
                         torch.from_numpy(center),
                         torch.from_numpy(scale), t["fps"], t["gt_rot"],
                         t["gt_trans"], t["extent"], OUT, residual=residual)
    return {k: v.numpy() for k, v in out.items()}


def _background_flips(rois, ref, ours):
    """[B] bool: the ROIs whose background coordinate comes from another
    keypoint on the JAX side (read back from its coordinate) than the
    port's, the lowest-index keypoint nearest the origin; each such pair
    must be a near-tie (squared norms within 1e-6 relative, in float64).
    The port's background coordinates are checked against that keypoint
    here, since the comparison with JAX skips the flipped ROIs'."""
    fps = rois["fps"].astype(np.float64)
    nearest = xyz_to_region(torch.zeros(len(fps), 1, 1, 3),
                            torch.from_numpy(rois["fps"]))[1].numpy()
    flips = np.zeros(len(fps), bool)
    for b in range(len(fps)):
        bg = ref["roi_region"][b] == 0
        if not bg.any():
            continue
        cand = np.einsum("ij,kj->ki", rois["gt_rot"][b], -fps[b]) \
            / rois["extent"][b] + 0.5                          # [K,3]
        theirs = np.abs(cand - ref["roi_xyz"][b][bg][0]).sum(-1).argmin()
        mine = np.abs(-fps[b] - nearest[b, 0, 0]).sum(-1).argmin()
        np.testing.assert_allclose(ours["roi_xyz"][b][bg],
                                   np.broadcast_to(cand[mine], (bg.sum(), 3)),
                                   rtol=0, atol=COORD_TOL)
        n2 = (fps[b] ** 2).sum(-1)
        flips[b] = theirs != mine
        assert abs(n2[theirs] - n2[mine]) <= 1e-6 * n2[mine]
    return flips


def assert_matches_jax(frames, rois, residual=True):
    ref = jax_labels(frames, rois, residual)
    cuda_build.reset_launches()
    ours = port_labels(frames, rois, ref["bbox_center"], ref["scale"],
                       residual)
    assert cuda_build.LAUNCHES.get("surface_labels", 0) == 0  # plain on CPU
    B = rois["frame_idx"].shape[0]
    for k in MASK_KEYS:
        assert ours[k].dtype == np.float32 and ours[k].shape == (B, OUT, OUT)
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert ours["roi_region"].dtype == np.int32
    assert ours["roi_xyz"].shape == (B, OUT, OUT, 3)
    same = ours["roi_region"] == ref["roi_region"]
    assert same.mean() >= ID_AGREE
    if residual:
        bg = ours["roi_region"] == 0
        same &= ~(bg & _background_flips(rois, ref, ours)[:, None, None])
    np.testing.assert_allclose(ours["roi_xyz"][same], ref["roi_xyz"][same],
                               rtol=0, atol=COORD_TOL)
    assert (ours["roi_mask_obj"] > 0).mean() > 0.05, "crops hold objects"
    return ours, ref


def _cropped_visib(rois, ref):
    v = torch.from_numpy(rois["mask_packed"] & 1 if "mask_packed" in rois
                         else rois["mask_visib"]).float()
    return crop_resize_frames(v, torch.arange(v.shape[0]),
                              torch.from_numpy(ref["bbox_center"]),
                              torch.from_numpy(ref["scale"]), OUT,
                              interp="nearest").numpy()


def test_packed_masks_match_jax():
    """The PBR split's inputs: packed masks, several ROIs a frame, crops
    off the frame's edges, half-pixel taps, depth holes under the mask."""
    frames, rois = scene()
    ours, ref = assert_matches_jax(frames, rois)
    assert not np.array_equal(ours["roi_mask_trunc"], ours["roi_mask_visib"])
    # a depth hole under the mask takes the pixel out of m
    assert ((_cropped_visib(rois, ref) > 0) & (ours["roi_mask_obj"] == 0)
            ).any()
    # ROI 0's and ROI 1's crops run off the frame: those taps read 0
    assert (ours["roi_mask_obj"][0, :4, :4] == 0).all()
    assert (ours["roi_mask_obj"][1, :, -4:] == 0).all()
    # ROI 2: every other source coordinate sits exactly on .5
    grid = np.arange(OUT, dtype=np.float32) - OUT / 2
    sx = ref["bbox_center"][2, 0] + grid * np.float32(ref["scale"][2] / OUT)
    assert (sx % 1 == 0.5).sum() == OUT // 2


@pytest.mark.parametrize("masks", ["trunc", "visib_only"])
def test_float_masks_match_jax(masks):
    frames, rois = scene(masks=masks, seed=3)
    ours, _ = assert_matches_jax(frames, rois)
    if masks == "trunc":
        assert not np.array_equal(ours["roi_mask_trunc"],
                                  ours["roi_mask_visib"])
    else:
        np.testing.assert_array_equal(ours["roi_mask_trunc"],
                                      ours["roi_mask_visib"])


@pytest.mark.parametrize("masks", ["packed", "trunc"])
def test_absolute_mode_matches_jax(masks):
    frames, rois = scene(masks=masks, seed=5)
    assert_matches_jax(frames, rois, residual=False)


@pytest.mark.parametrize("K", [96, 200])
def test_many_keypoints_match_jax(K):
    """Past the kernel's 64-keypoint shared-memory tile, in both
    coordinate modes."""
    frames, rois = scene(K=K, seed=K, edges=False)
    for residual in (True, False):
        ours, _ = assert_matches_jax(frames, rois, residual=residual)
        assert ours["roi_region"].max() > 64, "a pixel past the first tile"


def test_tie_across_the_keypoint_tile_goes_to_the_lower_index():
    """A 16x16 frame at 1 m, K's centre on column 8, R = I: every pixel of
    that column has xyz = (0, y, z), equidistant from keypoints 63 and 64
    (either side of the kernel's 64-keypoint tile); the lower index wins,
    as in JAX's argmin."""
    K = 131
    fps = np.full((1, K, 3), -1.0, np.float32)
    fps[0, :, 2] -= np.arange(K, dtype=np.float32) * 0.01    # all far away
    fps[0, 63], fps[0, 64] = (0.1, 0.0, 0.0), (-0.1, 0.0, 0.0)
    cam = np.array([[100.0, 0, 8.0], [0, 100.0, 8.0], [0, 0, 1]], np.float32)
    frames = {"rgb": np.zeros((1, 16, 16, 3), np.uint8),
              "depth": np.ones((1, 16, 16), np.float32), "K": cam[None]}
    rois = {"frame_idx": np.zeros(1, np.int32),
            "bbox": _box((8.0, 8.0), 16.0)[None],
            "mask_packed": np.full((1, 16, 16), 3, np.uint8),
            "gt_rot": np.eye(3, dtype=np.float32)[None],
            "gt_trans": np.array([[0.0, 0.0, 1.3]], np.float32),
            "fps": fps, "extent": np.full((1, 3), 0.1, np.float32),
            "centroid_2d": np.array([[8.0, 8.0]], np.float32)}
    ours, ref = assert_matches_jax(frames, rois)
    assert (ours["roi_region"][0, :, 8] == 64).all()
    np.testing.assert_array_equal(ours["roi_region"], ref["roi_region"])


def test_preprocessing_of_depth_raw_frames_matches_jax():
    """The slice as a whole on BOP-PBR-like frames (depth in 0.1 mm as
    uint16 + depth_factor): the port's ``preprocess_rois_grouped`` against
    the JAX package's, every key."""
    frames, rois = scene(seed=11)
    depth = frames.pop("depth")
    frames["depth_raw"] = np.round(depth * 10000).astype(np.uint16)
    frames["depth_factor"] = np.full(2, 10000.0, np.float32)
    ref = jax_labels(frames, rois)
    cfg = TConfig().apply_opts(TINY + ["head.num_regions=32"])
    ours = pipeline.preprocess_rois_grouped(
        cfg, {k: torch.from_numpy(v) for k, v in frames.items()},
        {k: torch.from_numpy(v) for k, v in rois.items()}, train=True,
        center_scale=(torch.from_numpy(ref["bbox_center"]),
                      torch.from_numpy(ref["scale"])))
    ours = {k: v.numpy() for k, v in ours.items()}
    assert set(ours) == set(ref)
    for k in MASK_KEYS + ("gt_rot", "gt_trans"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    same = ours["roi_region"] == ref["roi_region"]
    assert same.mean() >= ID_AGREE
    same &= ~((ours["roi_region"] == 0)
              & _background_flips(rois, ref, ours)[:, None, None])
    np.testing.assert_allclose(ours["roi_xyz"][same], ref["roi_xyz"][same],
                               rtol=0, atol=COORD_TOL)
    for k, tol in (("roi_img", 5e-5), ("roi_coord_2d", 5e-5),
                   ("trans_ratio", 1e-5), ("gt_allo_rot6d", 1e-6)):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, atol=tol,
                                   err_msg=k)


def test_depth_branch_goes_through_surface_labels(monkeypatch):
    """Without xyz maps the pipeline hands surface_labels the frames'
    depth, the ROIs' frame indices and K, and the packed masks as shipped;
    gt_labels is not called."""
    cfg = TConfig().apply_opts(TINY + ["head.num_regions=4"])
    frames, rois = tsyn.dummy_grouped_inputs(cfg, n_frames=1,
                                             rois_per_frame=2)
    seen = []

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return surface_labels(*args, **kwargs)

    def no_gt_labels(*args, **kwargs):
        raise AssertionError("gt_labels called without xyz maps")

    monkeypatch.setattr(pipeline, "surface_labels", spy)
    monkeypatch.setattr(pipeline, "gt_labels", no_gt_labels)
    out = pipeline.preprocess_rois_grouped(
        cfg, {k: torch.from_numpy(v) for k, v in frames.items()},
        {k: torch.from_numpy(v) for k, v in rois.items()}, train=True,
        center_scale=(torch.tensor([[60.0, 50.0], [70.0, 40.0]]),
                      torch.tensor([40.0, 50.0])))
    assert len(seen) == 1
    args, kwargs = seen[0]
    assert args[0].shape == (1, 120, 160) and args[0].dtype == torch.float32
    assert args[1].tolist() == [0, 0] and args[1].dtype == torch.int64
    assert args[2].dtype == torch.uint8 and args[3] is None
    assert args[4].shape == (2, 3, 3) and args[11] == 16
    assert kwargs["residual"] is True
    assert out["roi_mask_obj"] is out["roi_mask_visib"]


def test_surface_labels_refuses_bad_input():
    frames, rois = scene(edges=False)
    t = {k: torch.from_numpy(v) for k, v in {**frames, **rois}.items()}
    fidx = t["frame_idx"].long()
    base = dict(depth=t["depth"], frame_idx=fidx, mask=t["mask_packed"],
                trunc=None, cam=torch.from_numpy(frames["K"])[fidx],
                center=t["bbox"][:, :2].contiguous(),
                scale=t["bbox"][:, 2] - t["bbox"][:, 0], fps=t["fps"],
                rot=t["gt_rot"], trans=t["gt_trans"], extent=t["extent"])

    def call(**over):
        return surface_labels(**{**base, **over}, out_res=8)

    assert call()["roi_region"].shape == (6, 8, 8)
    with pytest.raises(TypeError):
        call(depth=t["depth"].double())
    with pytest.raises(TypeError):
        call(frame_idx=t["frame_idx"])                  # int32 indices
    with pytest.raises(TypeError):
        call(mask=t["mask_packed"].int())
    with pytest.raises(TypeError):
        call(trans=t["gt_trans"].double())
    with pytest.raises(ValueError):
        call(trunc=t["mask_packed"].float())     # packed masks carry trunc
    with pytest.raises(ValueError):
        call(mask=t["mask_packed"][:, :-1])      # not the frames' size
    with pytest.raises(ValueError):
        call(scale=base["scale"][:1])            # one scale for six ROIs
    with pytest.raises(ValueError):
        call(cam=torch.from_numpy(frames["K"]))  # K per frame, not per ROI
    with pytest.raises(ValueError):
        call(fps=t["fps"][:, :0])
    with pytest.raises(ValueError):
        call(depth=t["depth"].to("meta"))        # mixed devices
    with pytest.raises(ValueError):
        surface_labels(**base, out_res=0)
