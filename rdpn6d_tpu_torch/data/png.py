"""PNG read and write with numpy and zlib: the port's image codec.

The JAX package reads every image of its data path with OpenCV
(``cv2.imread``); the machine that runs the port on the card has neither
OpenCV nor Pillow, so the port decodes PNG itself, with one code path on
every machine. What it reads: non-interlaced files of colour type 0 (gray),
2 (RGB), 4 (gray + alpha) and 6 (RGBA), bit depth 8 or 16 (big-endian),
any of the five row filters. Arrays come back as stored, in RGB(A) order;
the readers below give OpenCV's results for the flags the data path uses
(``IMREAD_COLOR`` then BGR->RGB, ``IMREAD_UNCHANGED``,
``IMREAD_GRAYSCALE``), and refuse, rather than guess, a conversion the
data path never meant: a 16-bit file read as colour, a colour or 16-bit
file read as a mask.

Unfiltering runs a row at a time: Sub (a cumulative sum mod 256 per
channel) and Up are numpy operations, Avg and Paeth are loops over the
bytes of the row, since each byte depends on the one before it.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}          # colour type -> channels
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}        # channels -> colour type


def read_png(path: str) -> np.ndarray:
    """The image as stored: [H, W] (gray) or [H, W, C] (C = 2, 3, 4), uint8
    or uint16. A missing file raises FileNotFoundError; a file this codec
    does not read raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    header, idat, pos = None, [], 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}: {path}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r} fails its CRC: {path}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"PNG without IHDR or IDAT: {path}")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"PNG colour type {colour} at bit depth {depth} is "
                         f"not read (types 0/2/4/6 at 8 or 16 bits): {path}")
    if interlace:
        raise ValueError(f"interlaced PNG is not read: {path}")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8                 # bytes per pixel
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"PNG image data is short: {path}")
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    img = _unfilter(rows[:, 1:], rows[:, 0], bpp, path)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return img.reshape(shape)


def _unfilter(data: np.ndarray, kinds: np.ndarray, bpp: int,
              path: str) -> np.ndarray:
    out = np.array(data)                        # writable [H, stride]
    prev = np.zeros(out.shape[1], np.uint8)
    for y, kind in enumerate(kinds.tolist()):
        row = out[y]
        if kind == 1:                           # Sub
            row[:] = np.cumsum(row.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:                         # Up
            row += prev
        elif kind == 3:                         # Avg
            row[:] = _avg_row(row, prev, bpp)
        elif kind == 4:                         # Paeth
            row[:] = _paeth_row(row, prev, bpp)
        elif kind != 0:
            raise ValueError(f"PNG row {y} has filter type {kind}: {path}")
        prev = row
    return out


def _avg_row(row: np.ndarray, prev: np.ndarray, bpp: int) -> list[int]:
    cur, up = row.tolist(), prev.tolist()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + up[i]) >> 1)) & 0xFF
    return cur


def _paeth_row(row: np.ndarray, prev: np.ndarray, bpp: int) -> list[int]:
    cur, up = row.tolist(), prev.tolist()
    for i in range(bpp):                        # a = c = 0: predicts b
        cur[i] = (cur[i] + up[i]) & 0xFF
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], up[i], up[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        if pa <= pb and pa <= pc:
            p = a
        elif pb <= pc:
            p = b
        else:
            p = c
        cur[i] = (cur[i] + p) & 0xFF
    return cur


def _paeth_predict(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """Filter every row of [H, stride] uint8 with one filter type, from
    the unfiltered bytes (so no loop: encoding does not chain)."""
    if kind == 0:
        return rows.copy()
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    if kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    else:
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]
        pred = _paeth_predict(a, b, c)
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 0) -> None:
    """Write uint8 or uint16 [H, W] (gray) or [H, W, C] (C = 1..4: gray,
    gray + alpha, RGB, RGBA) as a PNG, every row with ``filter_type``
    (0 = None, 1 Sub, 2 Up, 3 Avg, 4 Paeth)."""
    a = np.asarray(img)
    if a.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png: uint8 or uint16 image, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"write_png: [H,W] or [H,W,1..4], got {img.shape}")
    if filter_type not in range(5):
        raise ValueError(f"write_png: filter type {filter_type}")
    height, width, channels = a.shape
    depth = 8 * a.dtype.itemsize
    data = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a)
    rows = data.view(np.uint8).reshape(height, -1)
    rows = _filter_rows(rows, channels * depth // 8, filter_type)
    raw = np.concatenate([np.full((height, 1), filter_type, np.uint8), rows],
                         axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    header = struct.pack(">IIBBBBB", width, height, depth,
                         _COLOUR_TYPE[channels], 0, 0, 0)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def imread_rgb(path: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_COLOR)`` then BGR->RGB: uint8 [H, W, 3];
    gray is copied to three channels, alpha dropped."""
    img = read_png(path)
    if img.dtype != np.uint8:
        raise ValueError(f"16-bit PNG read as a colour image: {path}")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    if img.shape[2] == 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def imread_unchanged(path: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_UNCHANGED)`` of a one-channel file (a
    depth map or a label image): [H, W] uint8 or uint16."""
    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"expected a one-channel PNG, got {img.shape[2]} "
                         f"channels: {path}")
    return img


def imread_mask(path: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_GRAYSCALE)`` of an 8-bit gray file (alpha
    dropped): [H, W] uint8."""
    img = read_png(path)
    if img.dtype != np.uint8 or (img.ndim == 3 and img.shape[2] != 2):
        raise ValueError(f"mask PNG must be 8-bit gray, got {img.dtype} "
                         f"{img.shape}: {path}")
    return img if img.ndim == 2 else np.ascontiguousarray(img[..., 0])
