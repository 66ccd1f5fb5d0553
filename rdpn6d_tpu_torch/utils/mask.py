"""Mask utilities: COCO-style RLE encode/decode, edges, morphology.

Counterpart of ``rdpn6d_tpu/utils/mask.py`` (the reference's
lib/utils/mask_utils.py) without OpenCV: the RLE helpers are its numpy
code; dilation, erosion and the morphological gradient are numpy max/min
filters, bit-equal to ``cv2.dilate``, ``cv2.erode`` and
``cv2.morphologyEx(MORPH_GRADIENT)`` with a square kernel of ones and
OpenCV's default border, which pads dilation with -inf and erosion with
+inf (a border pixel is never eroded by the outside). ``iterations``
passes of a k x k window are one pass of a window of n(k - 1) + 1, as
max and min filters compose.
"""

from __future__ import annotations

import numpy as np


def mask_to_rle(mask: np.ndarray) -> dict:
    """Binary [H, W] -> uncompressed COCO RLE (column-major counts)."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.flatten()  # Fortran order
    # run lengths, starting with zeros-run
    diff = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    runs = np.diff(np.concatenate([[0], diff, [len(flat)]]))
    counts = runs.tolist()
    if flat[0]:  # RLE starts with a zero-run by convention
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in rle["counts"]:
        if val:
            flat[pos:pos + c] = True
        pos += c
        val = not val
    if pos != h * w:
        # numpy slicing clamps silently — a truncated/corrupt RLE would
        # otherwise decode into a plausible-looking wrong mask
        raise ValueError(f"RLE counts sum to {pos}, expected {h * w}")
    return flat.reshape(w, h).T


def _filter(img: np.ndarray, size: int, reduce, pad: int) -> np.ndarray:
    """``reduce`` (np.max / np.min) over a centred size x size window,
    outside pixels taken as ``pad``; separable: rows, then columns."""
    r = size // 2
    out = img
    for axis in (0, 1):
        widths = [(0, 0), (0, 0)]
        widths[axis] = (r, r)
        padded = np.pad(out, widths, constant_values=pad)
        out = reduce(np.lib.stride_tricks.sliding_window_view(
            padded, size, axis=axis), axis=-1)
    return np.ascontiguousarray(out)


def _morph(mask, kernel: int, iterations: int, reduce, pad: int):
    if kernel < 1 or kernel % 2 == 0:
        raise ValueError(f"kernel must be odd and positive, got {kernel}")
    m = np.asarray(mask, np.uint8)
    if iterations <= 0:
        return m.copy()
    return _filter(m, iterations * (kernel - 1) + 1, reduce, pad)


def dilate_mask(mask: np.ndarray, kernel: int = 3,
                iterations: int = 1) -> np.ndarray:
    return _morph(mask, kernel, iterations, np.max, 0)


def erode_mask(mask: np.ndarray, kernel: int = 3,
               iterations: int = 1) -> np.ndarray:
    return _morph(mask, kernel, iterations, np.min, 255)


def mask_edges(mask: np.ndarray, kernel: int = 3) -> np.ndarray:
    """Edge band of a binary mask (morphological gradient)."""
    return (dilate_mask(mask, kernel) != erode_mask(mask, kernel)
            ).astype(np.uint8)


def mask_bbox_xyxy(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return np.zeros(4, np.float32)
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)
