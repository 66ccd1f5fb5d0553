"""The ROI crop (``ops/roi_crop``): its plain version against the JAX
package's eval-half preprocessing, the kernel's op sequence emulated in
numpy float32 against the plain version (at the division edges too), the
kernel's reciprocal division against IEEE division, its tile map (launch
plan, blocks, rows, every output element stored once) with the constants
and lines read from ``csrc/roi_crop.cu``, and its routing and refusals.

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
  ``_rn`` intrinsic in the order emulated here, and divides by each per-ROI
  constant through its reciprocal and two FMAs, each rounded once
  (``ops/int8_conv.fma_f32``), so this catches an op out of order before
  the card does;
* that division against numpy's IEEE float32 division: bit for bit, for
  every significand of the numerator at several divisors.
"""

import os
import re

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
from rdpn6d_tpu_torch.ops.int8_conv import fma_f32
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


def _recip(d):
    """The kernel's ``recip``: RN(1 / d) where |d| is in [2^-125, 2^125],
    else NaN (every quotient by d then takes the IEEE division)."""
    d = F32(d)
    return F32(1) / d if 2.0 ** -125 <= abs(d) <= 2.0 ** 125 else F32(np.nan)


def _div_rn(a, d, r):
    """The kernel's ``div_rn`` of float32 ``a`` by the scalar ``d`` with
    r = ``_recip(d)``: q0 = RN(a r), then RN(q0 + fma(-q0, d, a) r) with
    each FMA rounded once (``fma_f32``) where q0 and a are in the safe
    range, q0 where a = 0, and the correctly rounded a / d elsewhere."""
    a = np.asarray(a, F32)
    d, r = F32(d), F32(r)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        q0 = a * r
        m = np.abs(q0)
        fast = (m >= 2.0 ** -125) & (m <= 2.0 ** 125) \
            & (np.abs(a) >= 2.0 ** -100)
        ta, tq = torch.from_numpy(a), torch.from_numpy(q0)
        rem = fma_f32(-tq, torch.full_like(ta, float(d)), ta)
        q = fma_f32(rem, torch.full_like(ta, float(r)), tq).numpy()
        return np.where(fast, q, np.where((a == 0) & (q0 == 0), q0, a / d))


def emulate_kernel(rgb, depth, factor, K, fidx, center, scale, S, O, mean,
                   std, normalize, lx, ly):
    """``csrc/roi_crop.cu``'s arithmetic in numpy float32, op for op: the
    block's staged scalars and reciprocals, then each pixel's taps, blends,
    normalisation and back-projection (each division by a per-ROI constant
    through ``_div_rn``), and the O grid's coordinate map."""
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
                v = _div_rn(v - F32(mean[c]), std[c], _recip(std[c]))
            img[b, :, :, c] = v
        plane = depth[f] if factor is None else _div_rn(
            depth[f].astype(F32), factor[f], _recip(factor[f]))
        z = _div_rn(_blend(*taps(plane), fy, fx), ratio, _recip(ratio))
        img[b, :, :, 3] = _div_rn((j - kcx) * z, kfx, _recip(kfx))
        img[b, :, :, 4] = _div_rn((i - kcy) * z, kfy, _recip(kfy))
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


# Frames that drive each division by a per-ROI constant into its edge
# ranges, as (name, depth multiplier, factor (None: metres), K's fx and
# fy, stds); the depth is 0.6-1 m times the multiplier, as float32 metres
# or rounded to raw units: quotients below the normal range (depths near
# 10^-38; x and y near the principal point below 2^-100 too); z past
# 10^30 over an fx' near 10^-17, whose quotients overflow; the factors 1
# and 65535; stds whose reciprocals are inexact, one past 2^125 (its
# reciprocal subnormal) and one subnormal.
LM_STD = (58.395, 57.12, 57.375)
DIV_EDGES = [
    ("subnormal_metres", 1e-36, None, None, LM_STD),
    ("subnormal_raw", 3.0, 3e38, None, LM_STD),
    ("huge_z_tiny_fx_metres", 1e30, None, 1e-20, LM_STD),
    ("huge_z_tiny_fx_raw", 65535.0, 1e-30, 1e-20, LM_STD),
    ("factor_1", 1000.0, 1.0, None, LM_STD),
    ("factor_65535", 65535.0, 65535.0, None, LM_STD),
    ("inexact_std", 1.0, None, None, (3.0, 0.1, 7e37)),
    ("tiny_std", 1000.0, 1000.0, None, (1e-39, 1e-30, 255.0)),
]


def _edge_frames(mult, factor, fx, seed):
    """Two 40x56 frames of ``_frames`` with the depth times ``mult``, as
    float32 metres (a NaN pixel) or, with a ``factor``, int32 raw units;
    fx and fy replaced where ``fx`` is given."""
    frames = _frames(2, 40, 56, seed, "uint8", False)
    depth = frames.pop("depth").astype(np.float64) * mult
    if factor is not None:
        frames["depth_raw"] = np.round(depth).astype(np.int32)
        frames["depth_factor"] = np.full(2, factor, F32)
    else:
        frames["depth"] = depth.astype(F32)
        frames["depth"][0, 20, 18] = np.nan
    if fx is not None:
        frames["K"][:, 0, 0] = frames["K"][:, 1, 1] = fx
    return frames


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("edge", DIV_EDGES, ids=[e[0] for e in DIV_EDGES])
def test_kernel_emulation_bit_equal_at_division_edges(edge, normalize):
    """The kernel's divisions (``_div_rn``: the FMA path, the zero path and
    the IEEE branch) stay bit-equal to the plain version's quotients where
    they underflow, overflow or divide by an inexact reciprocal."""
    _, mult, factor, fx, std = edge
    raw = factor is not None
    frames = _edge_frames(mult, factor, fx, 13)
    # around the principal point, off the frame, half pixels, two frames
    rois = _rois([[8, 6, 48, 34], [-20, -10, 10, 12], [10, 7, 26, 23],
                  [20, 10, 50, 35]], [0, 0, 1, 1])
    center, scale_ = _box_crop(rois, 40, 56)
    mean = (123.675, 116.28, 103.53)
    key = "depth_raw" if raw else "depth"
    args = _crop_args(frames, rois, center, scale_)
    img, coord = rc.roi_crop_plain(*args, 32, 8, mean, std,
                                   normalize=normalize)
    lx, ly = (a.numpy() for a in rc.coord_axes(40, 56, "cpu"))
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        e_img, e_coord = emulate_kernel(
            frames["rgb"], frames[key], frames.get("depth_factor"),
            frames["K"], rois["frame_idx"], center.numpy(), scale_.numpy(),
            32, 8, mean, std, normalize, lx, ly)
    np.testing.assert_array_equal(e_img.view(np.int32)[~np.isnan(e_img)],
                                  img.numpy().view(np.int32)[~np.isnan(e_img)])
    np.testing.assert_array_equal(np.isnan(e_img), img.isnan().numpy())
    np.testing.assert_array_equal(e_coord, coord.numpy())
    xyz = img[..., 3:].numpy()
    tiny = (xyz != 0) & (np.abs(xyz) < 2.0 ** -126)
    if edge[0].startswith("subnormal"):
        assert tiny.any()                     # the edge is reached
    if edge[0].startswith("huge"):
        assert np.isinf(xyz).any()


def _all_mantissas():
    """Every float32 in [1, 2): with a normal divisor and no underflow or
    overflow, a quotient's rounding depends on the numerator's significand
    alone, so this binade stands for every normal numerator."""
    return ((np.arange(2 ** 23, dtype=np.int64) + (127 << 23))
            .astype(np.int32).view(F32))


@pytest.mark.parametrize("d", [58.395, 57.12, 57.375, 65535.0, 1000.0, 3.0,
                               0.1, 0.6113281, 1.1754944e-38, 2.0 ** 126])
def test_reciprocal_division_is_correctly_rounded(d):
    """``_div_rn`` (the kernel's ``div_rn``) equals IEEE float32 division for
    every significand of the numerator, scaled across the exponent range
    (so that the FMA path, the zero path and the IEEE branch are all
    taken), and for random numerators of every exponent; with the ±0, ±inf
    and NaN numerators."""
    a = _all_mantissas()
    r = _recip(d)
    with np.errstate(over="ignore", under="ignore", invalid="ignore",
                     divide="ignore"):
        for e in (0, -60, 60, -100, 100, -126, 127):
            # the whole binade at 2^0, every 97th significand elsewhere
            x = a if e == 0 else np.ldexp(a[::97], e).astype(F32)
            got = _div_rn(x, d, r)
            np.testing.assert_array_equal(got.view(np.int32),
                                          (x / F32(d)).view(np.int32))
        rng = np.random.RandomState(5)
        bits = rng.randint(0, 2 ** 31 - 1, 2 ** 20).astype(np.int32)
        x = np.concatenate([bits.view(F32), np.array(
            [0.0, -0.0, np.inf, -np.inf, np.nan, 2.0 ** -149], F32)])
        x = np.where(rng.rand(len(x)) < 0.5, -x, x).astype(F32)
        got, want = _div_rn(x, d, r), x / F32(d)
    same = (got.view(np.int32) == want.view(np.int32)) \
        | (np.isnan(got) & np.isnan(want))
    assert same.all(), x[~same][:5]


# ------------------------------------------- the kernel's tile map, in numpy

SRC = os.path.join(os.path.dirname(rc.__file__), os.pardir, "csrc",
                   "roi_crop.cu")


def _tile_consts():
    """``csrc/roi_crop.cu``'s block size and row limit (checked against
    the wrapper's plan), and the lines of its launch shape, tile map and
    shared-memory layout that ``_emulate_tiles`` follows."""
    with open(SRC) as f:
        text = f.read()
    consts = {}
    for name in ("kThreads", "kMaxRows"):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m, f"{name} not found in {SRC}"
        consts[name] = int(m.group(1))
    assert (consts["kThreads"], consts["kMaxRows"]) == (rc.THREADS,
                                                        rc.MAX_ROWS)
    assert re.search(r"__launch_bounds__\(kThreads, (\d+)\)",
                     text).group(1) == str(rc.BLOCKS_PER_SM)
    flat = " ".join(text.split())
    for line in (
            "const int nseg = (S + kThreads - 1) / kThreads;",
            "const int R = nseg == 1 ? kThreads / S : 1;",
            "const dim3 block(nseg == 1 ? S : kThreads, R);",
            "const dim3 grid(nseg == 1 ? (S + R * iters - 1) / (R * iters) "
            ": S * nseg, B);",
            "const int t = threadIdx.y * blockDim.x + threadIdx.x;",
            "const int row0 = nseg == 1 ? blockIdx.x * R * iters : "
            "blockIdx.x / nseg;",
            "const int col0 = nseg == 1 ? 0 : (blockIdx.x - row0 * nseg) * "
            "kThreads;",
            "const int rows = min(R * iters, S - row0);",
            "const int ncol = nseg == 1 ? S : min(kThreads, S - col0);",
            "const int pa = nseg == 1 ? min(row0 + R * k, S) * S : "
            "row0 * S + col0;",
            "const int pb = nseg == 1 ? min(row0 + R * k + R, S) * S : "
            "pa + ncol;",
            "r.io = i % stride == 0 ? i / stride : -1;",
            "const int j = col0 + threadIdx.x;",
            "const int jo = j % stride == 0 ? j / stride : -1;",
            "const bool col_live = (int)threadIdx.x < ncol;",
            "for (int it = 0; R * it < rows; ++it) {",
            "const int lr = R * it + threadIdx.y;",
            "const int2 yw = *reinterpret_cast<const int2*>(&srow[lr + R]);",
            "const int pa = (row0 + R * it) * S + col0;",
            "float* img_dst = roi_img + ((size_t)b * S * S + pa) * 6;",
            "float* coord_dst = roi_coord + ((size_t)b * O * O + g0) * 5;",
            "if (lr < rows && col_live) { const Row r = srow[lr];",
            "float2* o = reinterpret_cast<float2*>(img_dst + 6 * t);",
            "float* row = coord_dst + 5 * (r.io * O + jo - g0);",
            "if (t < ng) {",
            "float* row = coord_dst + 5 * t;"):
        assert line in flat, line
    return consts


def _grid_before(P, S, O, stride):
    """The kernel's ``grid_before``: O-grid pixels before S-grid pixel P."""
    i, j = P // S, P % S
    n = min(O, -(-i // stride)) * O
    if i % stride == 0 and i // stride < O:
        n += min(O, -(-j // stride))
    return n


def _conflicts(addrs, width):
    """Extra shared-memory wavefronts of one warp-wide access of ``width``
    bytes a lane at byte addresses ``addrs`` (active lanes only): a
    4-byte access is served for the whole warp at once, an 8-byte one a
    half-warp at a time, a 16-byte one a quarter-warp at a time; a bank
    serving two different words costs one more."""
    per = 128 // width
    extra = 0
    for g in range(0, 32, per):
        banks = {}
        for lane, a in addrs:
            if g <= lane < g + per:
                for w in range(a // 4, (a + width) // 4):
                    banks.setdefault(w % 32, set()).add(w)
        extra += max((len(v) for v in banks.values()), default=1) - 1
    return extra


def _emulate_map(B, S, O, sms):
    """Every block of the kernel's grid over B ROIs on ``sms`` SMs
    (``roi_crop_plan``): each iteration's pixels and the roi_img and
    roi_coord elements their threads store, and the warps' reads of the
    row table (``Row``, 32 bytes: two 16-byte reads, and the next row's
    first 8 bytes for the loads ahead). Returns (write counts of roi_img,
    of roi_coord, bank conflicts of the row reads)."""
    nthreads = _tile_consts()["kThreads"]
    iters, n_blocks = rc.roi_crop_plan(B, S, sms)
    stride = S // O
    nseg = -(-S // nthreads)
    R = nthreads // S if nseg == 1 else 1
    bdx = S if nseg == 1 else nthreads
    blocks = -(-S // (R * iters)) if nseg == 1 else S * nseg
    assert blocks * B == n_blocks
    nt = bdx * R
    n_img = np.zeros(B * S * S * 6, np.int64)
    n_coord = np.zeros(B * O * O * 5, np.int64)
    conflicts = 0
    t = np.arange(nt)
    tx, ty = t % bdx, t // bdx
    for b in range(B):
        for bx in range(blocks):
            row0 = bx * R * iters if nseg == 1 else bx // nseg
            col0 = 0 if nseg == 1 else (bx - row0 * nseg) * nthreads
            rows = min(R * iters, S - row0)
            ncol = S if nseg == 1 else min(nthreads, S - col0)
            j = col0 + tx
            jo = np.where(j % stride == 0, j // stride, -1)
            col_live = tx < ncol
            it = 0
            while R * it < rows:
                pa = (row0 + R * it) * S + col0
                pb = min(row0 + R * it + R, S) * S if nseg == 1 \
                    else pa + ncol
                g0 = _grid_before(pa, S, O, stride)
                ng = _grid_before(pb, S, O, stride) - g0
                lr = R * it + ty
                i = row0 + lr
                live = (lr < rows) & col_live
                assert (i * S + j - pa == t)[live].all()
                assert live.sum() == pb - pa
                io = np.where(i % stride == 0, i // stride, -1)
                for tt in t[live]:
                    at = (b * S * S + pa + tt) * 6
                    n_img[at:at + 6] += 1
                on_grid = live & (io >= 0) & (jo >= 0)
                gl = io * O + jo - g0
                assert (np.sort(gl[on_grid]) == np.arange(ng)).all()
                for tt in t[on_grid]:
                    at = (b * O * O + g0 + gl[tt]) * 5
                    n_coord[at:at + 3] += 1
                for tt in range(ng):
                    at = (b * O * O + g0 + tt) * 5
                    n_coord[at + 3:at + 5] += 1
                for w0 in range(0, nt, 32):
                    lanes = range(w0, min(w0 + 32, nt))
                    for half in (0, 16):
                        conflicts += _conflicts(
                            [(tt - w0, 32 * lr[tt] + half) for tt in lanes
                             if live[tt]], 16)
                    conflicts += _conflicts(
                        [(tt - w0, 32 * (lr[tt] + R)) for tt in lanes
                         if col_live[tt] and lr[tt] + R < rows], 8)
                it += 1
            assert it <= iters
    return n_img, n_coord, conflicts


@pytest.mark.parametrize("S,O,sms", [(256, 64, 132), (256, 64, 3),
                                     (128, 32, 132), (128, 32, 5),
                                     (33, 11, 132), (33, 11, 1),
                                     (300, 75, 132), (7, 7, 1), (1, 1, 1)])
def test_tile_map_writes_each_element_once(S, O, sms):
    """The kernel's blocks (whole rows of S <= kThreads pixels, R of them an
    iteration, as many iterations as ``roi_crop_plan`` gives on ``sms``
    SMs, up to kMaxRows rows: a ragged last iteration and a ragged last
    block at 33 / 11; kThreads-wide row segments, the last one ragged, at
    300 / 75) store every roi_img and roi_coord element exactly once, from
    the thread that computes it; 2 ROIs. Where a warp reads one or two rows
    of the row table (S >= 32) the reads are free of bank conflicts; below
    that a warp reads several rows, and rows 4 apart share banks."""
    n_img, n_coord, conflicts = _emulate_map(2, S, O, sms)
    assert (n_img == 1).all() and (n_coord == 1).all()
    if S >= 32:
        assert conflicts == 0


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
