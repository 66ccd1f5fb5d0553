"""Visualization helpers.

Counterpart of ``rdpn6d_tpu/utils/vis.py`` (the reference's
lib/vis_utils/image.py: grid_show, bbox and mask overlays) without OpenCV.
``grid_show`` imports matplotlib when called (absent on the GPU machine:
there it raises ImportError). ``draw_bbox`` paints what ``cv2.rectangle``
paints: at thickness 1 the one-pixel outline, at thickness t > 1 the
outline widened by OpenCV's filled circle of radius (t + 1) // 2 (a
4-neighbour cross at t = 2), at a negative thickness the filled box.
``draw_pose_axes`` draws each axis as a line sampled once a pixel step and
widened by the same cross, where OpenCV fills a fixed-point quadrilateral
around its segment: pixels may differ along the edges of the line
(``tests/test_torch_host_tools.py`` bounds where).
"""

from __future__ import annotations

import numpy as np


def grid_show(images: list[np.ndarray], titles: list[str] | None = None,
              rows: int = 1, save_path: str | None = None):
    """Show/save a grid of images. Returns the figure."""
    if save_path:
        # only headless saving needs Agg; switching the process-global
        # backend unconditionally would break interactive sessions
        import matplotlib

        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(images)
    cols = (n + rows - 1) // rows
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows),
                             squeeze=False)
    for i, img in enumerate(images):
        ax = axes[i // cols][i % cols]
        im = np.asarray(img)
        if im.ndim == 2:
            ax.imshow(im, cmap="viridis")
        else:
            ax.imshow(np.clip(im, 0, 1) if im.dtype.kind == "f" else im)
        if titles and i < len(titles):
            ax.set_title(titles[i], fontsize=8)
        ax.axis("off")
    for j in range(n, rows * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
    return fig


def _brush(thickness: int) -> list[tuple[int, int]]:
    """Offsets OpenCV's wide strokes paint around each pixel of a line."""
    r = (thickness + 1) // 2 if thickness > 1 else 0
    return [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)
            if dy * dy + dx * dx <= r * r]


def _paint(out: np.ndarray, ys: np.ndarray, xs: np.ndarray, color,
           thickness: int) -> None:
    """Set every pixel within the brush of a (ys, xs) stroke pixel."""
    h, w = out.shape[:2]
    hit = np.zeros((h, w), bool)
    for dy, dx in _brush(thickness):
        y, x = ys + dy, xs + dx
        ok = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        hit[y[ok], x[ok]] = True
    if out.ndim == 2:
        out[hit] = color[0]
    else:
        c = list(color)[:out.shape[2]]
        out[hit] = c + [0] * (out.shape[2] - len(c))


def draw_bbox(img: np.ndarray, bbox_xyxy, color=(0, 255, 0),
              thickness: int = 2) -> np.ndarray:
    out = np.ascontiguousarray(img).copy()
    x1, y1, x2, y2 = [int(v) for v in bbox_xyxy]
    x1, x2 = min(x1, x2), max(x1, x2)
    y1, y2 = min(y1, y2), max(y1, y2)
    h, w = out.shape[:2]
    # nothing beyond the brush's reach of the image can paint in it
    m = (thickness + 1) // 2 + 1
    x1, x2 = np.clip([x1, x2], -m, w + m)
    y1, y2 = np.clip([y1, y2], -m, h + m)
    if thickness < 0:
        ys, xs = np.mgrid[y1:y2 + 1, x1:x2 + 1]
        _paint(out, ys.ravel(), xs.ravel(), color, 1)
        return out
    xs = np.arange(x1, x2 + 1)
    ys = np.arange(y1, y2 + 1)
    _paint(out, np.concatenate([np.full_like(xs, y1), np.full_like(xs, y2),
                                ys, ys]),
           np.concatenate([xs, xs, np.full_like(ys, x1),
                           np.full_like(ys, x2)]), color, thickness)
    return out


def _line_pixels(p0, p1, h: int, w: int, margin: int):
    """Pixels of the segment p0 -> p1 (integer points) within the image
    grown by ``margin``: at each integer step of the longer axis, the other
    coordinate of the segment there, rounded (the whole segment's walk,
    whatever part of it the clip keeps)."""
    a, b = np.asarray(p0, np.int64), np.asarray(p1, np.int64)
    d = b - a
    major = int(np.abs(d).argmax())
    if d[major] == 0:
        return np.array([a[1]]), np.array([a[0]])
    lo, hi = sorted((a[major], b[major]))
    n = (w, h)[major]
    lo, hi = max(lo, -margin), min(hi, n - 1 + margin)
    m = np.arange(lo, hi + 1, dtype=np.int64)
    o = np.rint(a[1 - major] + (m - a[major]) * (d[1 - major] / d[major])
                ).astype(np.int64)
    keep = (o >= -margin) & (o <= (h, w)[major] - 1 + margin)
    m, o = m[keep], o[keep]
    return (o, m) if major == 0 else (m, o)


def overlay_mask(img: np.ndarray, mask: np.ndarray,
                 color=(0, 120, 255), alpha: float = 0.5) -> np.ndarray:
    out = np.asarray(img, np.float32).copy()
    m = np.asarray(mask, bool)
    out[m] = (1 - alpha) * out[m] + alpha * np.asarray(color, np.float32)
    return out.astype(img.dtype if np.asarray(img).dtype.kind == "u"
                      else np.float32)


def colorize_coords(coord: np.ndarray) -> np.ndarray:
    """Normalized [H, W, 3] coordinate map -> displayable RGB in [0, 1]."""
    c = np.asarray(coord, np.float32)
    lo, hi = np.nanmin(c), np.nanmax(c)
    return (c - lo) / max(hi - lo, 1e-6)


def draw_pose_axes(img: np.ndarray, K: np.ndarray, R: np.ndarray,
                   t: np.ndarray, length: float = 0.05) -> np.ndarray:
    """Project and draw the object's coordinate axes (x red, y green, z
    blue in BGR, 2 pixels wide)."""
    pts = np.float32([[0, 0, 0], [length, 0, 0], [0, length, 0],
                      [0, 0, length]])
    cam = pts @ R.T + t
    out = np.ascontiguousarray(img).copy()
    if cam[0, 2] <= 1e-6:  # origin behind the camera: nothing to anchor
        return out
    uv = (cam @ K.T)
    uv = np.clip(uv[:, :2] / np.maximum(uv[:, 2:3], 1e-6),
                 -1e6, 1e6).astype(int)
    h, w = out.shape[:2]
    for i, color in zip((1, 2, 3),
                        ((0, 0, 255), (0, 255, 0), (255, 0, 0))):
        if cam[i, 2] > 1e-6:  # skip only the axis that crosses the
            ys, xs = _line_pixels(uv[0], uv[i], h, w, 2)   # near plane
            _paint(out, ys, xs, color, 2)
    return out
