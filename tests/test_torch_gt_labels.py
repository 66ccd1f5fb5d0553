"""The fused GT labels (``ops/gt_labels.gt_labels``, its plain version on
the CPU) against the JAX package: the stacked nearest ``crop_resize_mm``
of the masks and the xyz map at precision="highest", then
``residual_coord_target`` (or ``xyz_to_region`` and xyz / extent + 0.5 in
absolute mode), as ``rdpn6d_tpu/data/pipeline.py`` composes them.

Inputs come from numpy seeds. Tolerances, as in test_torch_train_labels:

* masks exactly: both sides take the same taps (a one-hot matmul at
  "highest" reproduces the gather bit for bit) of 0/1 products;
* region ids on >= 0.999 of the pixels: the JAX side forms
  |x|^2 - 2 x.f + |f|^2, the port the direct sum of squares, so a pixel
  whose two nearest keypoints are closer than the rounding may flip;
* coordinates to 1e-5 wherever the ids agree: float32 products of values
  ~0.1 divided by extents ~0.1.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdpn6d_tpu.ops.region import residual_coord_target as j_residual
from rdpn6d_tpu.ops.region import xyz_to_region as j_xyz_to_region
from rdpn6d_tpu.ops.warp import crop_resize_mm as j_crop_mm
from rdpn6d_tpu_torch.data import pipeline
from rdpn6d_tpu_torch.ops import cuda_build
from rdpn6d_tpu_torch.ops.gt_labels import MAX_K, gt_labels

ID_AGREE = 0.999
COORD_TOL = 1e-5
MASK_KEYS = ("roi_mask_visib", "roi_mask_obj", "roi_mask_trunc")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rotations(rng, n):
    q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    return (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)


def gt_inputs(B=3, h=40, w=52, K=32, seed=0, masks="packed",
              xyz_dtype=np.float16):
    """Per-ROI GT maps with an elliptic object (xyz != 0 inside it), a
    visib mask that spills past the object (visib * obj must cut it), a
    trunc mask that differs from visib, keypoints, R and extents."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    obj = np.stack([((xx - rng.uniform(0.3, 0.7) * w) / (0.3 * w)) ** 2
                    + ((yy - rng.uniform(0.3, 0.7) * h) / (0.3 * h)) ** 2
                    < 1.0 for _ in range(B)])
    xyz = rng.uniform(-0.06, 0.06, (B, h, w, 3)) * obj[..., None]
    visib = (obj | (rng.rand(B, h, w) < 0.1)) & (rng.rand(B, h, w) < 0.9)
    trunc = visib & (rng.rand(B, h, w) < 0.7)
    out = {"xyz": xyz.astype(xyz_dtype),
           "fps": rng.uniform(-0.05, 0.05, (B, K, 3)).astype(np.float32),
           "rot": _rotations(rng, B),
           "extent": rng.uniform(0.05, 0.2, (B, 3)).astype(np.float32),
           "center": np.stack([rng.uniform(0.3, 0.7, B) * w,
                               rng.uniform(0.3, 0.7, B) * h], 1)
           .astype(np.float32),
           "scale": rng.uniform(0.5, 1.2, B).astype(np.float32)
           * max(h, w)}
    if masks == "packed":
        out["mask"] = (visib.astype(np.uint8)
                       | (trunc.astype(np.uint8) << 1))
        out["trunc"] = None
    else:
        out["mask"] = visib.astype(np.float32)
        out["trunc"] = trunc.astype(np.float32) if masks == "trunc" \
            else None
    return out


def jax_gt_labels(inp, out_res, residual):
    """The JAX package's composition of the same labels."""
    mask, trunc = inp["mask"], inp["trunc"]
    if mask.dtype == np.uint8:
        visib_in = (mask & 1).astype(np.float32)
        trunc_in = ((mask >> 1) & 1).astype(np.float32)
    else:
        visib_in, trunc_in = mask, trunc
    xyz = jnp.asarray(inp["xyz"]).astype(jnp.float32)
    obj = ((xyz[..., 0] != 0) | (xyz[..., 1] != 0)
           | (xyz[..., 2] != 0)).astype(jnp.float32)
    planes = [(visib_in * obj)[..., None], obj[..., None], xyz]
    if trunc_in is not None:
        planes.append((trunc_in * obj)[..., None])
    crop = jax.vmap(partial(j_crop_mm, out_size=out_res, precision="highest",
                            interp="nearest"))
    stacked = crop(jnp.concatenate(planes, -1), jnp.asarray(inp["center"]),
                   jnp.asarray(inp["scale"]))
    xyz_c = stacked[..., 2:5]
    fps, rot, ext = (jnp.asarray(inp[k]) for k in ("fps", "rot", "extent"))
    if residual:
        region, coord = j_residual(xyz_c, fps, rot, ext)
    else:
        region, _ = j_xyz_to_region(xyz_c, fps)
        coord = xyz_c / ext[:, None, None, :] + 0.5
    visib = stacked[..., 0]
    out = {"roi_mask_visib": visib, "roi_mask_obj": stacked[..., 1],
           "roi_mask_trunc": stacked[..., 5] if trunc_in is not None
           else visib, "roi_region": region, "roi_xyz": coord}
    return {k: np.asarray(v) for k, v in out.items()}


def torch_gt_labels(inp, out_res, residual):
    t = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v))
         for k, v in inp.items()}
    out = gt_labels(t["mask"], t["trunc"], t["xyz"], t["center"],
                    t["scale"], t["fps"], t["rot"], t["extent"], out_res,
                    residual=residual)
    return {k: v.numpy() for k, v in out.items()}


def assert_matches_jax(inp, out_res, residual=True):
    ref = jax_gt_labels(inp, out_res, residual)
    cuda_build.reset_launches()
    ours = torch_gt_labels(inp, out_res, residual)
    assert cuda_build.LAUNCHES.get("gt_labels", 0) == 0     # plain on CPU
    assert set(ours) == set(ref)
    B = inp["xyz"].shape[0]
    for k in MASK_KEYS:
        assert ours[k].dtype == np.float32 and ours[k].shape == \
            (B, out_res, out_res)
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert ours["roi_region"].dtype == np.int32
    assert ours["roi_xyz"].shape == (B, out_res, out_res, 3)
    same = ours["roi_region"] == ref["roi_region"]
    assert same.mean() >= ID_AGREE
    np.testing.assert_allclose(ours["roi_xyz"][same], ref["roi_xyz"][same],
                               rtol=0, atol=COORD_TOL)
    return ours


@pytest.mark.parametrize("K", [1, 32, 64])
def test_packed_half_xyz_with_offset_matches_jax(K):
    """The main path's inputs: packed masks, float16 xyz shipped as crops
    whose top-left sits at xyz_offset in the frame."""
    inp = gt_inputs(K=K, seed=K)
    offset = np.array([[17.0, 9.0], [3.0, 41.0], [0.0, 0.0]], np.float32)
    frame_center = inp["center"] + offset
    # the pipeline's op: the frame centre minus the offset, in float32
    inp["center"] = (torch.from_numpy(frame_center)
                     - torch.from_numpy(offset)).numpy()
    ours = assert_matches_jax(inp, 16)
    assert (ours["roi_mask_obj"] > 0).mean() > 0.2, "crops hold the objects"
    assert not np.array_equal(ours["roi_mask_trunc"], ours["roi_mask_visib"])


@pytest.mark.parametrize("masks", ["trunc", "visib_only"])
def test_float_masks_match_jax(masks):
    inp = gt_inputs(B=2, masks=masks, xyz_dtype=np.float32, seed=5)
    ours = assert_matches_jax(inp, 16)
    if masks == "trunc":      # trunc differs from visib in the inputs
        assert not np.array_equal(ours["roi_mask_trunc"],
                                  ours["roi_mask_visib"])
    else:
        np.testing.assert_array_equal(ours["roi_mask_trunc"],
                                      ours["roi_mask_visib"])


@pytest.mark.parametrize("masks", ["packed", "trunc"])
def test_absolute_mode_matches_jax(masks):
    assert_matches_jax(gt_inputs(masks=masks, seed=7), 16, residual=False)


def test_crops_off_the_map_edges_match_jax():
    inp = gt_inputs(B=4, seed=9)
    h, w = inp["xyz"].shape[1:3]
    inp["center"] = np.array([[2.0, 3.0], [w - 1.5, h - 2.0], [-5.0, h / 2],
                              [w / 2, h + 4.0]], np.float32)
    inp["scale"] = np.array([30.0, 41.0, 25.0, 2.5 * max(h, w)], np.float32)
    ours = assert_matches_jax(inp, 16)
    off = ours["roi_xyz"][ours["roi_mask_obj"] == 0]
    assert (ours["roi_mask_obj"] == 0).mean() > 0.3 and off.size


def test_half_pixel_taps_round_to_even_like_jax():
    """scale / out = 0.5 with integer centres: every other source
    coordinate sits exactly on .5; both sides round it half to even."""
    inp = gt_inputs(B=2, h=24, w=24, seed=11)
    inp["center"] = np.array([[12.0, 11.0], [9.0, 14.0]], np.float32)
    inp["scale"] = np.array([8.0, 8.0], np.float32)
    ours = assert_matches_jax(inp, 16)
    grid = np.arange(16, dtype=np.float32) - 8
    for b in range(2):
        sx, sy = (inp["center"][b, i] + grid * np.float32(0.5)
                  for i in (0, 1))
        assert (sx % 1 == 0.5).sum() == 8 and (sy % 1 == 0.5).sum() == 8
        ix, iy = np.round(sx).astype(int), np.round(sy).astype(int)
        obj = np.any(inp["xyz"][b] != 0, -1).astype(np.float32)
        np.testing.assert_array_equal(ours["roi_mask_obj"][b],
                                      obj[iy][:, ix])


def test_xyz_branch_goes_through_gt_labels(monkeypatch):
    """The pipeline's xyz branch hands its maps to gt_labels as shipped:
    packed uint8 masks and float16 xyz, with the offset-shifted centre."""
    from rdpn6d_tpu_torch.config import Config
    from rdpn6d_tpu_torch.data import synthetic

    cfg = Config().apply_opts(["data.input_res=64", "data.out_res=16",
                               "head.out_res=16", "head.num_regions=4"])
    frames, rois = synthetic.dummy_grouped_inputs(cfg, n_frames=1,
                                                  rois_per_frame=2,
                                                  ship_xyz=True)
    seen = []

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return gt_labels(*args, **kwargs)

    monkeypatch.setattr(pipeline, "gt_labels", spy)
    pipeline.preprocess_rois_grouped(
        cfg, {k: torch.from_numpy(v) for k, v in frames.items()},
        {k: torch.from_numpy(v) for k, v in rois.items()}, train=True,
        center_scale=(torch.tensor([[60.0, 50.0], [70.0, 40.0]]),
                      torch.tensor([40.0, 50.0])))
    assert len(seen) == 1
    args, kwargs = seen[0]
    assert args[0].dtype == torch.uint8 and args[1] is None
    assert args[2].dtype == torch.float16
    assert args[8] == 16 and kwargs["residual"] is True


def test_gt_labels_refuses_bad_input():
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in gt_inputs(B=2, K=4).items()}
    args = [t[k] for k in ("mask", "trunc", "xyz", "center", "scale", "fps",
                           "rot", "extent")]

    def call(**over):
        a = dict(zip(("mask", "trunc", "xyz", "center", "scale", "fps",
                      "rot", "extent"), args))
        a.update(over)
        return gt_labels(*a.values(), 8)

    with pytest.raises(TypeError):
        call(xyz=t["xyz"].double())
    with pytest.raises(TypeError):
        call(mask=t["mask"].int())
    with pytest.raises(TypeError):
        call(fps=t["fps"].double())
    with pytest.raises(ValueError):
        call(trunc=t["mask"].float())           # packed masks carry trunc
    with pytest.raises(ValueError):
        call(xyz=t["xyz"][:, :-1])              # map sizes differ
    with pytest.raises(ValueError):
        call(scale=t["scale"][:1])              # one scale for two ROIs
    with pytest.raises(ValueError):
        call(fps=torch.zeros(2, MAX_K + 1, 3))  # K > the kernel's limit
    with pytest.raises(ValueError):
        call(fps=t["fps"][:, :0])
    with pytest.raises(ValueError):
        call(xyz=t["xyz"].to("meta"))           # mixed devices
