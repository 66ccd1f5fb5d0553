"""The port's host modules against the JAX package's: ``utils/mask``
(OpenCV morphology there), ``ops/view_sampler``, ``utils/vis`` (OpenCV
drawing there), ``ops/pnp_host`` (OpenCV's EPnP, RANSAC and iterative
solver there) and ``utils/profiling``.

Tolerances:
  * masks, RLE, view directions, rotations, boxes: bit for bit.
  * ``draw_pose_axes``: OpenCV fills a fixed-point quadrilateral around a
    2-pixel line where the port widens a sampled line by a cross, so
    pixels differ along the line's edges (12% of cv2's painted pixels in
    this file's poses). Bound: each pixel one paints and the other does
    not lies within one pixel (8-neighbourhood) of a pixel the other
    paints, and within two on the image's outermost rows and columns,
    where OpenCV's clip paints a column the line only grazes.
  * ``pnp_ransac``, exact correspondences: both within 1e-6 of the ground
    truth (measured ~5e-8). 30% outliers with noise uniform in ±1 px: the
    port's R and t within 1e-3 of cv2's (both keep every true inlier and
    no outlier, so both refine on the same set; measured ≤ 4.4e-4). With
    Gaussian noise of 1 px some true inliers lie beyond the 3 px
    threshold and which ones each side keeps depends on its random
    samples, so there only the reprojection RMS over the true inliers is
    held: the port's ≤ 1.05 × cv2's. ``method="iterative"`` (both refine
    EPnP on all points to the least-squares optimum): within 1e-5.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from rdpn6d_tpu.ops import pnp_host as j_pnp
from rdpn6d_tpu.ops import view_sampler as j_views
from rdpn6d_tpu.utils import mask as j_mask
from rdpn6d_tpu.utils import profiling as j_prof
from rdpn6d_tpu.utils import vis as j_vis
from rdpn6d_tpu_torch.ops import pnp_host, view_sampler
from rdpn6d_tpu_torch.utils import mask, profiling, vis

K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
              [0.0, 0.0, 1.0]])


def _masks(seed, n=12):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = rng.randint(5, 48, 2)
        m = (rng.rand(h, w) < (0.15, 0.5, 0.85)[i % 3]).astype(np.uint8)
        # touching every edge
        m[0, rng.randint(w)] = m[-1, rng.randint(w)] = 1
        m[rng.randint(h), 0] = m[rng.randint(h), -1] = 1
        if i % 4 == 0:
            m *= 255
        if i % 4 == 1:
            m[:] = 1          # full: the border must not erode
        out.append(m)
    return out


@pytest.mark.parametrize("kernel", [3, 5, 7])
@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_morphology_bit_equal_to_cv2(kernel, iterations):
    for m in _masks(kernel * 10 + iterations):
        for ours, ref in ((mask.dilate_mask, j_mask.dilate_mask),
                          (mask.erode_mask, j_mask.erode_mask)):
            a, b = ours(m, kernel, iterations), ref(m, kernel, iterations)
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(mask.mask_edges(m, kernel),
                                      j_mask.mask_edges(m, kernel))


def test_morphology_edge_cases():
    m = _masks(99)[0]
    for it in (0, 1):
        np.testing.assert_array_equal(mask.dilate_mask(m, 1, it),
                                      j_mask.dilate_mask(m, 1, it))
    np.testing.assert_array_equal(mask.erode_mask(m, 3, 0),
                                  j_mask.erode_mask(m, 3, 0))
    with pytest.raises(ValueError):
        mask.dilate_mask(m, 4)


def test_rle_and_bbox_match():
    for m in _masks(5):
        rle = mask.mask_to_rle(m)
        assert rle == j_mask.mask_to_rle(m)
        np.testing.assert_array_equal(mask.rle_to_mask(rle), m > 0)
        np.testing.assert_array_equal(mask.mask_bbox_xyxy(m),
                                      j_mask.mask_bbox_xyxy(m))
    np.testing.assert_array_equal(mask.mask_bbox_xyxy(np.zeros((4, 4))),
                                  np.zeros(4, np.float32))
    bad = {"size": [3, 4], "counts": [2, 3]}
    for fn in (mask.rle_to_mask, j_mask.rle_to_mask):
        with pytest.raises(ValueError):
            fn(bad)


@pytest.mark.parametrize("hemisphere", [False, True])
def test_view_sampler_matches(hemisphere):
    for n in (1, 7, 100):
        np.testing.assert_array_equal(
            view_sampler.fibonacci_sphere(n, hemisphere),
            j_views.fibonacci_sphere(n, hemisphere))
    for n in (10, 42, 200):
        ours = view_sampler.icosphere_views(n, 0.7, hemisphere)
        np.testing.assert_array_equal(
            ours, j_views.icosphere_views(n, 0.7, hemisphere))
        np.testing.assert_array_equal(view_sampler.look_at_rotations(ours),
                                      j_views.look_at_rotations(ours))


@pytest.mark.parametrize("thickness", [1, 2])
def test_draw_bbox_bit_equal_to_cv2(thickness):
    rng = np.random.RandomState(thickness)
    for i in range(200):
        h, w = rng.randint(8, 70, 2)
        img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        if i % 5 == 0:
            img = img[..., 0].copy()                # gray
        box = rng.randint(-12, 80, 4)                # any order, off-image
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        np.testing.assert_array_equal(
            vis.draw_bbox(img, box, color, thickness),
            j_vis.draw_bbox(img, box, color, thickness), err_msg=str(box))


def _axes_poses(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        R = q * np.sign(np.linalg.det(q))
        t = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.25, 0.25),
                      rng.uniform(0.3, 1.5)])
        yield R, t, rng.uniform(0.03, 0.2)


def _near(src, dst, reach):
    """Pixels of ``dst`` farther than ``reach`` (8-neighbourhood steps)
    from every pixel of ``src``."""
    return dst & ~ndimage.binary_dilation(
        src, np.ones((3, 3), bool), iterations=reach)


def test_draw_pose_axes_within_a_pixel_of_cv2():
    import cv2

    h, w = 480, 640
    differ = painted = 0
    for R, t, length in _axes_poses(120, 0):
        img = np.zeros((h, w, 3), np.uint8)
        ours = vis.draw_pose_axes(img, K, R, t, length)
        ref = j_vis.draw_pose_axes(img, K, R, t, length)
        assert ours.shape == ref.shape and ours.dtype == ref.dtype
        code = ours.reshape(-1, 3).astype(np.int64) @ [1, 256, 65536]
        assert np.isin(code, [0, 255 * 65536, 255 * 256, 255]).all()
        # each axis alone (a later axis paints over an earlier one)
        pts = np.float32([[0, 0, 0], [length, 0, 0], [0, length, 0],
                          [0, 0, length]])
        uv = (pts @ R.T + t) @ K.T
        uv = np.clip(uv[:, :2] / uv[:, 2:3], -1e6, 1e6).astype(int)
        for i in (1, 2, 3):
            a = np.zeros((h, w), np.uint8)
            cv2.line(a, tuple(uv[0]), tuple(uv[i]), 1, 2)
            b = np.zeros((h, w), np.uint8)
            ys, xs = vis._line_pixels(uv[0], uv[i], h, w, 2)
            vis._paint(b, ys, xs, (1,), 2)
            A, B = a > 0, b > 0
            assert A.any() == B.any()
            differ += int((A ^ B).sum())
            painted += int(A.sum())
            if not (A ^ B).any():
                continue
            rows = np.nonzero((A | B).any(1))[0]
            cols = np.nonzero((A | B).any(0))[0]
            # the bounding box, with the image's outermost rows and
            # columns marked where the box reaches them
            y0, y1 = max(rows[0] - 3, 0), min(rows[-1] + 4, h)
            x0, x1 = max(cols[0] - 3, 0), min(cols[-1] + 4, w)
            A, B = A[y0:y1, x0:x1], B[y0:y1, x0:x1]
            edge = np.zeros(A.shape, bool)
            edge[[0, -1], :] |= np.array([y0 == 0, y1 == h])[:, None]
            edge[:, [0, -1]] |= np.array([x0 == 0, x1 == w])[None, :]
            for src, dst in ((A, B), (B, A)):
                assert not (_near(src, dst, 1) & ~edge).any()
                assert not _near(src, dst, 2).any()
    assert differ <= 0.15 * painted, (differ, painted)


def test_overlay_and_colorize_match():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (20, 30, 3)).astype(np.uint8)
    m = rng.rand(20, 30) > 0.5
    np.testing.assert_array_equal(vis.overlay_mask(img, m),
                                  j_vis.overlay_mask(img, m))
    f = rng.rand(20, 30, 3).astype(np.float32)
    np.testing.assert_array_equal(vis.overlay_mask(f, m, alpha=0.3),
                                  j_vis.overlay_mask(f, m, alpha=0.3))
    c = rng.randn(16, 16, 3).astype(np.float32)
    c[0, 0, 0] = np.nan
    np.testing.assert_array_equal(vis.colorize_coords(c),
                                  j_vis.colorize_coords(c))


def test_grid_show_is_matplotlib_gated(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    imgs = [np.zeros((8, 8, 3), np.uint8), np.ones((8, 8), np.float32)]
    path = tmp_path / "grid.png"
    vis.grid_show(imgs, ["a", "b"], rows=1, save_path=str(path))
    assert path.stat().st_size > 0
    import builtins

    real = builtins.__import__

    def no_mpl(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(ImportError, match="matplotlib"):
        vis.grid_show(imgs)


def _scene(seed, noise, outliers=0.3, n=200, half=0.1):
    rng = np.random.RandomState(seed)
    p3 = rng.uniform(-half, half, (n, 3))
    q, _ = np.linalg.qr(rng.randn(3, 3))
    R = q * np.sign(np.linalg.det(q))
    t = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                  rng.uniform(0.5, 1.0)])
    uv = (p3 @ R.T + t) @ K.T
    p2 = uv[:, :2] / uv[:, 2:]
    p2 = p2 + (rng.uniform(-1, 1, (n, 2)) if noise == "uniform"
               else rng.randn(n, 2) * noise)
    bad = rng.choice(n, int(outliers * n), replace=False)
    p2[bad] = rng.uniform(0, 1, (len(bad), 2)) * [640, 480]
    inl = np.ones(n, bool)
    inl[bad] = False
    return p3, p2, R, t, inl


def _rms(R, t, p3, p2):
    return float(np.sqrt(np.mean(pnp_host._errors(
        K, R.astype(np.float64), t.astype(np.float64), p3, p2) ** 2)))


def test_pnp_exact_correspondences():
    for seed in range(4):
        p3, p2, R, t, _ = _scene(seed, 0.0, outliers=0.0)
        for fn in (pnp_host.pnp_ransac, j_pnp.pnp_ransac):
            Re, te = fn(p3, p2, K)
            assert Re.dtype == te.dtype == np.float32
            assert np.abs(Re - R).max() <= 1e-6 and np.abs(te - t).max() \
                <= 1e-6, fn


def test_pnp_ransac_with_outliers_matches_cv2():
    for seed in range(6):
        p3, p2, R, t, inl = _scene(seed, "uniform")
        Ro, to = pnp_host.pnp_ransac(p3, p2, K)
        Rc, tc = j_pnp.pnp_ransac(p3, p2, K)
        assert np.abs(Ro - Rc).max() <= 1e-3 and np.abs(to - tc).max() \
            <= 1e-3, seed
    for seed in range(6):
        p3, p2, R, t, inl = _scene(10 + seed, 1.0)
        Ro, to = pnp_host.pnp_ransac(p3, p2, K)
        Rc, tc = j_pnp.pnp_ransac(p3, p2, K)
        assert _rms(Ro, to, p3[inl], p2[inl]) <= \
            1.05 * _rms(Rc, tc, p3[inl], p2[inl]), seed


def test_pnp_iterative_and_few_points():
    p3, p2, R, t, inl = _scene(20, 1.0, outliers=0.0)
    Ro, to = pnp_host.pnp_ransac(p3, p2, K, method="iterative")
    Rc, tc = j_pnp.pnp_ransac(p3, p2, K, method="iterative")
    assert np.abs(Ro - Rc).max() <= 1e-5 and np.abs(to - tc).max() <= 1e-5
    for n in (0, 3):
        for fn in (pnp_host.pnp_ransac, j_pnp.pnp_ransac):
            Re, te = fn(p3[:n], p2[:n], K)
            np.testing.assert_array_equal(Re, np.eye(3, dtype=np.float32))
            np.testing.assert_array_equal(te, np.zeros(3, np.float32))
    # the same seed draws the same samples
    a = pnp_host.pnp_ransac(p3, p2, K, rng=np.random.default_rng(5))
    b = pnp_host.pnp_ransac(p3, p2, K, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(a[0], b[0])


def test_correspondences_from_maps_match():
    rng = np.random.RandomState(4)
    coord = rng.randn(64, 64, 3).astype(np.float32)
    m = rng.rand(64, 64) > 0.3
    for kw in ({}, {"max_points": 100, "seed": 3}):
        a = pnp_host.correspondences_from_maps(coord, m, np.array(
            [320.0, 240.0]), 180.0, **kw)
        b = j_pnp.correspondences_from_maps(coord, m, np.array(
            [320.0, 240.0]), 180.0, **kw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    empty = pnp_host.correspondences_from_maps(coord, m & False,
                                               np.zeros(2), 1.0)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 2)


def test_step_timer_and_trace(tmp_path):
    ours, ref = profiling.StepTimer(), j_prof.StepTimer()
    for timer in (ours, ref):
        for _ in range(2):
            with timer.measure("step") as sync:
                sync({"a": torch.ones(3) * 2, "b": [torch.zeros(1)]})
        with pytest.raises(RuntimeError):
            with timer.measure("boom"):
                raise RuntimeError("x")
    assert set(ours.summary()) == set(ref.summary()) == {"step", "boom"}
    assert ours.counts == ref.counts
    assert "step:" in ours.report() and "boom:" in ours.report()
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("region"):
            torch.ones(8).sum()
    text = (tmp_path / "prof" / "trace.json").read_text()
    assert "region" in text
