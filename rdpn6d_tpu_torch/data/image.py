"""Image files by their signature: PNG through ``data/png.py``, JPEG
through ``data/jpeg.py``, TIFF (ITODD's gray frames) through
``data/tif.py``.

``imread_rgb`` is the port's ``cv2.imread(path, IMREAD_COLOR)`` followed by
BGR->RGB for any of them, as the JAX package reads frames and
backgrounds; masks and depth maps stay PNG (``png.imread_mask``,
``png.imread_unchanged``), as BOP stores them. ``resize_linear`` is
``cv2.resize`` (INTER_LINEAR) of uint8 images, byte for byte, for the
background pool.
"""

from __future__ import annotations

import numpy as np

from . import jpeg, png, tif


def image_format(path: str) -> str:
    """"png", "jpeg" or "tif" by the file's signature (a BigTIFF is "tif",
    so ``data/tif.py`` refuses it by name); other formats raise
    ValueError, a missing file FileNotFoundError."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(jpeg.SIGNATURE):
        return "jpeg"
    if head == png.SIGNATURE:
        return "png"
    if tif.is_tif(head) or head[:4] in tif.BIGTIFF_SIGNATURES:
        return "tif"
    raise ValueError(f"neither PNG, JPEG nor TIFF: {path}")


def _linear_taps(n_out: int, n_in: int, clamp: bool
                 ) -> tuple[np.ndarray, ...]:
    """OpenCV's taps of a linear resize along one axis: the two source
    indices and their 11-bit fixed-point weights. The source position
    (i + 0.5) * scale - 0.5 is rounded to float32, the weights are
    round(w * 2048) of the float32 weights (each on its own). Along x
    (``clamp``) a position outside the image takes its edge pixel at full
    weight; along y only the rows are clipped, the weights stay."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        edge = (s < 0) | (s >= n_in - 1)
        f[edge] = 0.0
        s = np.clip(s, 0, n_in - 1)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w0, w1)


def resize_linear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` (INTER_LINEAR) of a uint8 [H, W] or
    [H, W, C] image to ``size`` = (width, height), byte for byte:

    - the same size is a copy;
    - an exact 2x downscale on both axes is OpenCV's INTER_AREA there:
      (a + b + c + d + 2) >> 2 over each 2x2 cell;
    - otherwise the horizontal pass sums the two taps with 11-bit weights
      into int32, and the vertical pass is OpenCV's bit-exact form
      (((s0 >> 4) * w0 >> 16) + ((s1 >> 4) * w1 >> 16) + 2) >> 2.
    """
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise TypeError(f"resize_linear: uint8 image, got {a.dtype}")
    W, H = int(size[0]), int(size[1])
    h, w = a.shape[:2]
    if (h, w) == (H, W):
        return a.copy()
    x = a.astype(np.int64)
    if (w, h) == (2 * W, 2 * H):
        return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2]
                 + x[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(W, w, clamp=True)
    y0, y1, b0, b1 = _linear_taps(H, h, clamp=False)
    chan = (None,) * (a.ndim - 2)
    rows = x[:, x0] * a0[(slice(None),) + chan] \
        + x[:, x1] * a1[(slice(None),) + chan]         # [h, W(, C)]
    col = (slice(None), None) + chan
    out = (((rows[y0] >> 4) * b0[col] >> 16)
           + ((rows[y1] >> 4) * b1[col] >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def imread_rgb(path: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_COLOR)`` then BGR->RGB, for PNG, JPEG or
    one-channel TIFF by the file's signature: uint8 [H, W, 3]; gray is
    copied to three channels (and a PNG's alpha dropped)."""
    kind = image_format(path)
    if kind == "png":
        return png.imread_rgb(path)
    if kind == "tif":
        return tif.imread_rgb(path)
    img = jpeg.read_jpeg(path)
    return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img
