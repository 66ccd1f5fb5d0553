"""The ROI crop (``ops/roi_crop``): its plain version against the JAX
package's eval-half preprocessing, the kernel's op sequence emulated in
numpy float32 against the plain version, and its routing and refusals.

Inputs are seeded numpy frames (a smooth RGB pattern, a depth surface with
holes) at small sizes. Tolerances:

* against the JAX package (``rdpn6d_tpu/data/pipeline.py``
  ``preprocess_rois_grouped(train=False)``): 1e-5 absolute and 1e-6
  relative, as ``test_torch_slice.py``: the TPU path crops by matmul, the
  port by gather, so the four taps are summed in other orders;
* the element-wise crop intrinsics against ``crop_K`` of ``crop_affine``:
  1 ulp (the matrix product sums the same two non-zero terms, with zeros,
  in an order of its own);
* the numpy emulation of the kernel against the plain version: bit for bit,
  NaN where the plain version has NaN. The kernel rounds every op with an
  ``_rn`` intrinsic in the order emulated here, so this catches an op out
  of order before the card does.
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
from rdpn6d_tpu_torch.geometry.camera import crop_K
from rdpn6d_tpu_torch.ops import roi_crop as rc
from rdpn6d_tpu_torch.ops.warp import crop_affine

F32 = np.float32
MEAN = (0.0, 0.0, 0.0)
STD = (255.0, 255.0, 255.0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _frames(F, H, W, seed, rgb_dtype, raw):
    """F frames: a smooth RGB pattern (uint8 or float32 0..255), a depth
    surface ~0.6-1.0 m with 5% holes, as int32 raw units (factor 1000 or
    10000) or float32 metres, and LineMOD-like intrinsics scaled to W."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(F32)
    rgb = np.stack([127.5 + 120 * np.sin(xx / (3 + c) + yy / 5 + rng.rand())
                    for f in range(F) for c in range(3)], -1)
    rgb = rgb.reshape(H, W, F, 3).transpose(2, 0, 1, 3)
    rgb = rgb.astype(np.uint8) if rgb_dtype == "uint8" \
        else (rgb + rng.rand(*rgb.shape)).astype(F32)
    depth = (0.6 + 0.2 * rng.rand(F, 1, 1) + 0.1 * np.sin(xx / 7)
             * np.cos(yy / 9)) * (rng.rand(F, H, W) > 0.05)
    f = 572.4 * W / 640
    K = np.stack([np.array([[f, 0, W / 2 + 0.3 * i], [0, f * 1.002, H / 2],
                            [0, 0, 1]], F32) for i in range(F)])
    frames = {"rgb": rgb, "K": K}
    if raw:
        factor = np.array([1000.0, 10000.0] * F, F32)[:F]
        frames["depth_raw"] = np.round(depth * factor[:, None, None]) \
            .astype(np.int32)
        frames["depth_factor"] = factor
    else:
        frames["depth"] = depth.astype(F32)
    return frames


def _rois(boxes, frame_idx, K=4):
    boxes = np.asarray(boxes, F32)
    B = len(boxes)
    return {"frame_idx": np.asarray(frame_idx, np.int64), "bbox": boxes,
            "fps": np.zeros((B, K, 3), F32),
            "extent": np.full((B, 3), 0.1, F32)}


# (name, F, H, W, S, O, rgb dtype, raw depth, boxes xyxy, frame_idx)
CASES = [
    ("uint8_raw", 1, 48, 64, 32, 8, "uint8", True,
     [[10, 8, 40, 30], [20.5, 5.25, 33.75, 21]], [0, 0]),
    ("float_metres", 1, 48, 64, 32, 8, "float32", False,
     [[10, 8, 40, 30], [2, 30, 30, 47]], [0, 0]),
    ("two_frames", 2, 40, 56, 32, 8, "uint8", True,
     [[5, 5, 30, 30], [20, 10, 50, 35], [0, 0, 56, 40], [30, 2, 44, 12],
      [12, 20, 25, 39]], [1, 0, 1, 0, 1]),
    # off every edge, wholly off the frame, taps on exact half pixels
    # (an integer centre and a step of 0.75 on the S grid, of 3 on the O
    # grid)
    ("edges", 1, 40, 56, 32, 8, "float32", True,
     [[-20, -10, 10, 12], [40, 25, 70, 52], [-90, -80, -60, -50],
      [10, 7, 26, 23]], [0, 0, 0, 0]),
    # a degenerate box (scale clamped to 1) and one larger than the frame
    # (scale clamped to max(H, W))
    ("degenerate", 1, 40, 56, 32, 8, "uint8", False,
     [[20, 20, 20, 20], [-40, -40, 100, 90]], [0, 0]),
    ("res_64_16", 2, 60, 80, 64, 16, "uint8", True,
     [[10, 10, 50, 45], [30, 5, 79, 59]], [1, 0]),
]


def _torch(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def _box_crop(rois, H, W):
    """The eval-time (center, scale) of the boxes, as both packages form
    them (no jitter)."""
    return pipeline.dzi_jitter(torch.from_numpy(rois["bbox"]), (H, W))


def _crop_args(frames, rois, center, scale):
    t = _torch(frames)
    depth = t.get("depth_raw", t.get("depth"))
    return (t["rgb"], depth, t.get("depth_factor"), t["K"],
            torch.from_numpy(rois["frame_idx"]), center, scale)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jax_eval_preprocessing(case):
    _, F, H, W, S, O, rgb_dtype, raw, boxes, fidx = case
    frames = _frames(F, H, W, 7, rgb_dtype, raw)
    rois = _rois(boxes, fidx)
    opts = [f"data.input_res={S}", f"data.out_res={O}"]
    j = j_grouped(JConfig().apply_opts(opts),
                  {k: jnp.asarray(v) for k, v in frames.items()},
                  {k: jnp.asarray(v) for k, v in rois.items()},
                  jax.random.PRNGKey(0), train=False)
    out = pipeline.preprocess_rois_grouped(TConfig().apply_opts(opts),
                                           _torch(frames), _torch(rois))
    center, scale = _box_crop(rois, H, W)
    img, coord = rc.roi_crop_plain(*_crop_args(frames, rois, center, scale),
                                   S, O, MEAN, STD)
    assert torch.equal(out["roi_img"], img)
    assert torch.equal(out["roi_coord_2d"], coord)
    assert img.shape == (len(boxes), S, S, 6)
    assert coord.shape == (len(boxes), O, O, 5)
    for k in ("roi_img", "roi_coord_2d", "roi_cam", "resize_ratio"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(j[k]),
                                   rtol=1e-6, atol=1e-5, err_msg=k)


def _ulps(a, b):
    """Distance in float32 ulps, via the ordered integer images."""
    def ordered(x):
        i = np.asarray(x, F32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def test_crop_intrinsics_match_crop_K():
    rng = np.random.RandomState(3)
    B = 4096
    f = rng.uniform(300, 1200, (B, 2)).astype(F32)
    K = np.zeros((B, 3, 3), F32)
    K[:, 0, 0], K[:, 1, 1] = f[:, 0], f[:, 1]
    K[:, :2, 2] = rng.uniform(100, 500, (B, 2))
    K[:, 0, 1] = rng.uniform(-1, 1, B)          # a skew, where K has one
    K[:, 2, 2] = 1
    K[:B // 2, 2, :2] = rng.uniform(-1e-3, 1e-3, (B // 2, 2))
    center = torch.from_numpy(rng.uniform(-50, 700, (B, 2)).astype(F32))
    scale = torch.from_numpy(rng.uniform(1, 640, B).astype(F32))
    Kt = torch.from_numpy(K)
    for S in (256, 64, 33):
        ours = rc.crop_intrinsics(Kt, center, scale, S).numpy()
        ref = crop_K(Kt, crop_affine(center, scale, S)).numpy()
        assert _ulps(ours, ref).max() <= 1, S
        assert np.array_equal(ours[:, 2], K[:, 2])


def _axis(s, n):
    """The kernel's ``axis``: clamped taps, validities, fraction."""
    x0 = np.floor(s)
    f = (s - x0).astype(F32)
    k = x0.astype(np.int64)
    return (np.clip(k, 0, n - 1), np.clip(k + 1, 0, n - 1),
            (k >= 0) & (k < n), (k + 1 >= 0) & (k + 1 < n), f)


def _blend(v00, v01, v10, v11, fy, fx):
    one = F32(1)
    gy, gx = one - fy, one - fx
    return (((v00 * gy) * gx + (v01 * gy) * fx) + (v10 * fy) * gx) \
        + (v11 * fy) * fx


def emulate_kernel(rgb, depth, factor, K, fidx, center, scale, S, O, mean,
                   std, normalize, lx, ly):
    """``csrc/roi_crop.cu``'s arithmetic in numpy float32, op for op: the
    block's staged scalars, then each pixel's taps, blends, normalisation
    and back-projection, and the O grid's coordinate map."""
    B = len(fidx)
    H, W = rgb.shape[1], rgb.shape[2]
    stride = S // O
    img = np.zeros((B, S, S, 6), F32)
    coord = np.zeros((B, O, O, 5), F32)
    j = np.arange(S, dtype=F32)[None, :]
    i = np.arange(S, dtype=F32)[:, None]
    for b in range(B):
        f = fidx[b]
        cx, cy, sc = center[b, 0], center[b, 1], scale[b]
        step_s, step_o = sc / F32(S), sc / F32(O)
        ratio = (F32(1) / sc) * F32(O)
        r = (F32(1) / sc) * F32(S)
        half = F32(0.5) * F32(S)
        k = K[f]
        t = [half - r * c for c in (cx, cy)]
        kfx = r * k[0, 0] + t[0] * k[2, 0]
        kfy = r * k[1, 1] + t[1] * k[2, 1]
        kcx = r * k[0, 2] + t[0] * k[2, 2]
        kcy = r * k[1, 2] + t[1] * k[2, 2]
        x0, x1, vx0, vx1, fx = _axis(cx + (j - half) * step_s, W)
        y0, y1, vy0, vy1, fy = _axis(cy + (i - half) * step_s, H)
        w = {(0, 0): (vy0 & vx0).astype(F32), (0, 1): (vy0 & vx1).astype(F32),
             (1, 0): (vy1 & vx0).astype(F32), (1, 1): (vy1 & vx1).astype(F32)}
        ys, xs = {0: y0, 1: y1}, {0: x0, 1: x1}

        def taps(plane):
            return [plane[ys[a], xs[c]].astype(F32) * w[a, c]
                    for a in (0, 1) for c in (0, 1)]

        for c in range(3):
            v = _blend(*taps(rgb[f, :, :, c]), fy, fx)
            if normalize:
                v = (v - F32(mean[c])) / F32(std[c])
            img[b, :, :, c] = v
        plane = depth[f] if factor is None \
            else depth[f].astype(F32) / factor[f]
        z = _blend(*taps(plane), fy, fx) / ratio
        img[b, :, :, 3] = ((j - kcx) * z) / kfx
        img[b, :, :, 4] = ((i - kcy) * z) / kfy
        img[b, :, :, 5] = z
        coord[b, :, :, :3] = img[b, ::stride, ::stride, 3:]
        jo = np.arange(O, dtype=F32)[None, :]
        io = np.arange(O, dtype=F32)[:, None]
        half_o = F32(0.5) * F32(O)
        bx0, bx1, ux0, ux1, gx = _axis(cx + (jo - half_o) * step_o, W)
        by0, by1, uy0, uy1, gy = _axis(cy + (io - half_o) * step_o, H)
        u00, u01 = (uy0 & ux0).astype(F32), (uy0 & ux1).astype(F32)
        u10, u11 = (uy1 & ux0).astype(F32), (uy1 & ux1).astype(F32)
        coord[b, :, :, 3] = _blend(lx[bx0] * u00, lx[bx1] * u01,
                                   lx[bx0] * u10, lx[bx1] * u11, gy, gx)
        coord[b, :, :, 4] = _blend(ly[by0] * u00, ly[by0] * u01,
                                   ly[by1] * u10, ly[by1] * u11, gy, gx)
    return img, coord


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_emulation_is_bit_equal_to_plain(case, normalize):
    _, F, H, W, S, O, rgb_dtype, raw, boxes, fidx = case
    frames = _frames(F, H, W, 11, rgb_dtype, raw)
    # a NaN inside the frame: every output whose taps reach it is NaN
    key = "depth_raw" if raw else "depth"
    if not raw:
        frames[key][0, H // 2, W // 3] = np.nan
    rois = _rois(boxes, fidx)
    center, scale = _box_crop(rois, H, W)
    mean, std = (0.485 * 255, 0.456 * 255, 0.406 * 255), (58.4, 57.1, 57.4)
    img, coord = rc.roi_crop_plain(*_crop_args(frames, rois, center, scale),
                                   S, O, mean, std, normalize=normalize)
    lx, ly = (a.numpy() for a in rc.coord_axes(H, W, "cpu"))
    e_img, e_coord = emulate_kernel(
        frames["rgb"], frames[key], frames.get("depth_factor"), frames["K"],
        rois["frame_idx"], center.numpy(), scale.numpy(), S, O, mean, std,
        normalize, lx, ly)
    np.testing.assert_array_equal(e_img, img.numpy())
    np.testing.assert_array_equal(e_coord, coord.numpy())
    if not raw:
        assert np.isnan(e_img).any() == bool(img.isnan().any())


def test_coord_axes_are_linspace_not_a_quotient():
    lx, ly = rc.coord_axes(480, 640, "cpu")
    assert rc.coord_axes(480, 640, "cpu")[0] is lx       # cached
    assert torch.equal(lx, torch.linspace(0.0, 1.0, 640))
    assert ly.shape == (480,)
    quotient = torch.arange(640, dtype=torch.float32) / 639
    assert not torch.equal(lx, quotient)


def test_normalize_off_then_normalize_equals_on():
    frames = _frames(2, 40, 56, 5, "uint8", True)
    rois = _rois(CASES[2][8], CASES[2][9])
    center, scale = _box_crop(rois, 40, 56)
    args = _crop_args(frames, rois, center, scale)
    mean, std = (123.7, 116.3, 103.5), (58.4, 57.1, 57.4)
    on = rc.roi_crop(*args, 32, 8, mean, std)
    off = rc.roi_crop(*args, 32, 8, mean, std, normalize=False)
    assert torch.equal(on[1], off[1])
    assert torch.equal(on[0][..., 3:], off[0][..., 3:])
    norm = (off[0][..., :3] - torch.tensor(mean)) / torch.tensor(std)
    assert torch.equal(on[0][..., :3], norm)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_refusals(device):
    frames = _frames(1, 20, 24, 0, "uint8", True)
    rois = _rois([[2, 2, 12, 12]], [0])
    center, scale = _box_crop(rois, 20, 24)
    args = [None if a is None else a.to(device)
            for a in _crop_args(frames, rois, center, scale)]
    rgb, depth, factor, K, fidx, c, s = args

    def call(*a, S=16, O=4):
        return rc.roi_crop(*a, S, O, MEAN, STD)

    with pytest.raises(TypeError):                      # float64 rgb
        call(rgb.double(), depth, factor, K, fidx, c, s)
    with pytest.raises(TypeError):                      # uint16 raw depth
        call(rgb, depth.to(torch.int16), factor, K, fidx, c, s)
    with pytest.raises(TypeError):                      # raw without factor
        call(rgb, depth, None, K, fidx, c, s)
    with pytest.raises(TypeError):                      # metres with factor
        call(rgb, depth.float(), factor, K, fidx, c, s)
    with pytest.raises(TypeError):
        call(rgb, depth, factor, K, fidx.int(), c, s)
    with pytest.raises(TypeError):
        call(rgb, depth, factor, K.double(), fidx, c, s)
    with pytest.raises(ValueError):                     # K per ROI
        call(rgb, depth, factor, K[:, :2], fidx, c, s)
    with pytest.raises(ValueError):                     # no O grid stride
        call(rgb, depth, factor, K, fidx, c, s, S=30, O=8)
    with pytest.raises(ValueError):
        call(rgb, depth, factor, K, fidx, c, s, S=8, O=16)
    with pytest.raises(ValueError):                     # mixed devices
        call(rgb, depth, factor, K, torch.zeros(
            1, dtype=torch.int64, device="meta" if device == "cpu"
            else "cpu"), c, s)
    if device == "meta":
        with pytest.raises(ValueError, match="no kernel"):
            call(rgb, depth, factor, K, fidx, c, s)


def test_cuda_wrapper_refuses_cpu_tensors():
    frames = _frames(1, 20, 24, 0, "uint8", True)
    rois = _rois([[2, 2, 12, 12]], [0])
    center, scale = _box_crop(rois, 20, 24)
    with pytest.raises(ValueError, match="CUDA tensors required"):
        rc.roi_crop_cuda(*_crop_args(frames, rois, center, scale), 16, 4,
                         MEAN, STD)


@pytest.mark.parametrize("train,aug", [(False, False), (True, False),
                                       (True, True)])
def test_preprocessing_calls_roi_crop_once(monkeypatch, train, aug):
    """``preprocess_rois_grouped`` crops through one ``roi_crop`` call in
    eval and train mode; with colour aug it crops without normalising and
    normalises the augmented RGB, as the plain chain did."""
    calls = []

    def spy(*a, **kw):
        calls.append(kw.get("normalize", True))
        return rc.roi_crop(*a, **kw)

    monkeypatch.setattr(pipeline, "roi_crop", spy)
    opts = ["data.input_res=32", "data.out_res=8"]
    if aug:
        opts += ["data.color_aug_prob=1.0", 'data.color_aug_type="code"']
    cfg = TConfig().apply_opts(opts)
    frames, rois = tsyn.dummy_grouped_inputs(cfg, n_frames=2,
                                             rois_per_frame=2, seed=1)
    gen = torch.Generator().manual_seed(0)
    out = pipeline.preprocess_rois_grouped(cfg, _torch(frames), _torch(rois),
                                           train=train, generator=gen)
    assert calls == [not aug]
    assert out["roi_img"].shape == (4, 32, 32, 6)
    assert bool(out["roi_img"].isfinite().all())
    if aug:          # the augmented RGB lies in the normalised 0..1 range
        assert float(out["roi_img"][..., :3].max()) <= 1.0
