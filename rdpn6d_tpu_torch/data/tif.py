"""TIFF read and write with numpy and zlib: the port's reader of ITODD's
gray frames.

The JAX package reads ITODD's ``gray/*.tif`` frames with
``cv2.imread(path, IMREAD_COLOR)`` (libtiff underneath) and turns BGR into
RGB; the machine that runs the port on the card has neither OpenCV,
libtiff nor Pillow, so the port reads TIFF itself. What it reads: the
first image of a little- (``II*\\0``) or big-endian (``MM\\0*``) file, one
sample a pixel (BlackIsZero), 8 or 16 bits of unsigned integer, in strips
or tiles, stored raw or compressed with PackBits, LZW or Deflate, with or
without the horizontal predictor. Anything else (BigTIFF, palette, RGB,
float or signed samples, other compressions, the floating-point
predictor, old-style LZW) raises ValueError naming what it found.

``imread_rgb`` gives OpenCV's ``IMREAD_COLOR`` result in RGB order: the
gray plane in three channels, a 16-bit one as v >> 8 (OpenCV's cut to
8 bits, not a rounding). ``write_tif`` writes what the reader reads, for
the synthetic trees and the tests; OpenCV reads its files too.

LZW decodes a code at a time in Python (the codes depend on the table
the earlier codes built); the predictor's running sum and the byte swaps
are numpy operations.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURES = (b"II*\x00", b"MM\x00*")
BIGTIFF_SIGNATURES = (b"II+\x00", b"MM\x00+")

# tag numbers (TIFF 6.0)
_WIDTH, _HEIGHT, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_FILL_ORDER, _STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP = 266, 273, 277, 278
_STRIP_BYTES, _PLANAR, _PREDICTOR, _COLOR_MAP = 279, 284, 317, 320
_TILE_WIDTH, _TILE_LENGTH, _TILE_OFFSETS, _TILE_BYTES = 322, 323, 324, 325
_SAMPLE_FORMAT = 339

# field type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4),
          11: ("f", 4), 12: ("d", 8)}

_COMPRESSIONS = {1: "none", 5: "lzw", 8: "deflate", 32946: "deflate",
                 32773: "packbits"}
_CODES = {"none": 1, "lzw": 5, "deflate": 8, "packbits": 32773}

_CLEAR, _EOI, _FIRST = 256, 257, 258


def is_tif(head: bytes) -> bool:
    return head[:4] in SIGNATURES


def _read_ifd(data: bytes, where: str) -> tuple[str, dict[int, tuple]]:
    """(byte order, {tag: values}) of the file's first image."""
    if data[:4] in BIGTIFF_SIGNATURES:
        raise ValueError(f"BigTIFF is not read: {where}")
    if not is_tif(data):
        raise ValueError(f"not a TIFF file: {where}")
    e = "<" if data[:2] == b"II" else ">"
    (off,) = struct.unpack_from(e + "I", data, 4)
    if off + 2 > len(data):
        raise ValueError(f"truncated TIFF header: {where}")
    (n,) = struct.unpack_from(e + "H", data, off)
    tags: dict[int, tuple] = {}
    for i in range(n):
        tag, typ, count, value = struct.unpack_from(
            e + "HHI4s", data, off + 2 + 12 * i)
        if typ not in _TYPES:
            continue        # types this reader has no use for (RATIONAL)
        code, size = _TYPES[typ]
        raw = value if count * size <= 4 else data[
            struct.unpack(e + "I", value)[0]:][:count * size]
        if len(raw) < count * size:
            raise ValueError(f"truncated TIFF tag {tag}: {where}")
        if typ == 2:
            tags[tag] = (raw[:count],)
        else:
            tags[tag] = struct.unpack(e + code * count, raw[:count * size])
    return e, tags


def _one(tags: dict, tag: int, default=None):
    v = tags.get(tag)
    if v is None:
        return default
    return v[0]


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of a TIFF file's first image, from its header."""
    with open(path, "rb") as f:
        data = f.read()
    _, tags = _read_ifd(data, path)
    return int(_one(tags, _WIDTH)), int(_one(tags, _HEIGHT))


def _lzw_decode(data: bytes, where: str) -> bytes:
    """TIFF LZW: MSB-first codes of 9 to 12 bits, the width growing one
    code early (at table sizes 511, 1023 and 2047), as libtiff reads it."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        raise ValueError(f"old-style (bit-reversed) LZW is not read: "
                         f"{where}")
    out = bytearray()
    buf = data + b"\x00\x00\x00"
    nbits = 8 * len(data)
    pos, width, mask = 0, 9, 511
    table: list[bytes] = [bytes((i,)) for i in range(256)] + [b"", b""]
    prev = b""
    while pos + width <= nbits:
        i = pos >> 3
        code = ((buf[i] << 16 | buf[i + 1] << 8 | buf[i + 2])
                >> (24 - width - (pos & 7))) & mask
        pos += width
        if code == _CLEAR:
            del table[_FIRST:]
            width, mask, prev = 9, 511, b""
            continue
        if code == _EOI:
            break
        n = len(table)
        if not prev:
            if code >= 256:
                raise ValueError(f"corrupt LZW data (code {code} after a "
                                 f"clear): {where}")
            entry = table[code]
        else:
            if code < n:
                entry = table[code]
            elif code == n:
                entry = prev + prev[:1]
            else:
                raise ValueError(f"corrupt LZW data (code {code} past the "
                                 f"table's {n}): {where}")
            if n < 4096:
                table.append(prev + entry[:1])
                n += 1
                if n == 511 or n == 1023 or n == 2047:
                    width += 1
                    mask = (1 << width) - 1
        out += entry
        prev = entry
    return bytes(out)


def _packbits_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def read_tif(path: str) -> np.ndarray:
    """The first image as stored: [H, W] uint8 or uint16. A missing file
    raises FileNotFoundError; a file this reader does not read raises
    ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    e, tags = _read_ifd(data, path)
    W, H = _one(tags, _WIDTH), _one(tags, _HEIGHT)
    if W is None or H is None:
        raise ValueError(f"TIFF without its size: {path}")
    spp = _one(tags, _SAMPLES, 1)
    bits = tags.get(_BITS, (1,))
    photometric = _one(tags, _PHOTOMETRIC)
    fmt = _one(tags, _SAMPLE_FORMAT, 1)
    if spp != 1 or photometric != 1 or _COLOR_MAP in tags:
        raise ValueError(
            f"only one-channel BlackIsZero TIFF is read, found "
            f"{spp} samples, photometric {photometric}: {path}")
    if bits[0] not in (8, 16) or fmt != 1:
        raise ValueError(f"only 8- and 16-bit unsigned samples are read, "
                         f"found {bits[0]} bits of sample format {fmt}: "
                         f"{path}")
    if _one(tags, _FILL_ORDER, 1) != 1:
        raise ValueError(f"TIFF fill order 2 is not read: {path}")
    comp_code = _one(tags, _COMPRESSION, 1)
    comp = _COMPRESSIONS.get(comp_code)
    if comp is None:
        raise ValueError(f"TIFF compression {comp_code} is not read "
                         "(none, PackBits, LZW and Deflate are): "
                         f"{path}")
    predictor = _one(tags, _PREDICTOR, 1)
    if predictor not in (1, 2):
        raise ValueError(f"TIFF predictor {predictor} is not read (1 and "
                         f"2 are): {path}")
    dt = np.dtype(np.uint8) if bits[0] == 8 \
        else np.dtype(e + "u2")

    if _TILE_OFFSETS in tags:
        bw, bh = _one(tags, _TILE_WIDTH), _one(tags, _TILE_LENGTH)
        offsets, counts = tags[_TILE_OFFSETS], tags.get(_TILE_BYTES)
        across = -(-W // bw)
        blocks = [((k // across) * bh, (k % across) * bw, bh, bw)
                  for k in range(len(offsets))]
    else:
        rps = min(_one(tags, _ROWS_PER_STRIP, H), H)
        offsets, counts = tags.get(_STRIP_OFFSETS), tags.get(_STRIP_BYTES)
        if offsets is None:
            raise ValueError(f"TIFF without strip offsets: {path}")
        blocks = [(k * rps, 0, min(rps, H - k * rps), W)
                  for k in range(len(offsets))]
    if counts is None or len(counts) != len(offsets):
        raise ValueError(f"TIFF without the byte counts of its "
                         f"{len(offsets)} blocks: {path}")
    img = np.zeros((H, W), dt.newbyteorder("="))
    for (y, x, bh, bw), off, cnt in zip(blocks, offsets, counts):
        raw = data[off:off + cnt]
        need = bh * bw * dt.itemsize
        if comp == "lzw":
            raw = _lzw_decode(raw, path)
        elif comp == "deflate":
            raw = zlib.decompress(raw)
        elif comp == "packbits":
            raw = _packbits_decode(raw, need)
        if len(raw) < need:
            raise ValueError(f"TIFF block at ({y}, {x}) holds {len(raw)} "
                             f"of its {need} bytes: {path}")
        block = np.frombuffer(raw[:need], dt).reshape(bh, bw).astype(
            dt.newbyteorder("="))
        if predictor == 2:
            block = np.cumsum(block, axis=1, dtype=block.dtype)
        h, w = min(bh, H - y), min(bw, W - x)
        img[y:y + h, x:x + w] = block[:h, :w]
    return img


def imread_rgb(path: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_COLOR)`` then BGR->RGB of a one-channel
    TIFF: uint8 [H, W, 3], a 16-bit plane cut to its high byte."""
    img = read_tif(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    return np.repeat(img[..., None], 3, axis=2)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW of ``data``, starting with a clear code and ending with
    EOI, the width growing as ``_lzw_decode`` expects and the table
    cleared when it is full. The codes are found in a Python loop, then
    packed MSB-first with numpy."""
    codes, widths = [_CLEAR], [9]
    width = 9
    if data:
        table: dict[int, int] = {}
        free = _FIRST
        w = data[0]
        for c in data[1:]:
            key = (w << 8) | c
            code = table.get(key)
            if code is not None:
                w = code
                continue
            codes.append(w)
            widths.append(width)
            table[key] = free
            free += 1
            w = c
            if free == 4094:
                codes.append(_CLEAR)
                widths.append(width)
                table.clear()
                free, width = _FIRST, 9
            elif free > (1 << width) - 1:
                width += 1
        codes.append(w)
        widths.append(width)
        # the decoder adds an entry for the last code, so its width may
        # grow before EOI
        if free + 1 > (1 << width) - 1 and width < 12:
            width += 1
    codes.append(_EOI)
    widths.append(width)
    c = np.asarray(codes, np.int64)
    wd = np.asarray(widths, np.int64)
    start = np.cumsum(wd) - wd
    j = np.arange(12)
    take = j[None, :] < wd[:, None]
    bits = np.zeros(int(wd.sum()), np.uint8)
    pos = (start[:, None] + j[None, :])[take]
    bits[pos] = ((c[:, None] >> (wd[:, None] - 1 - j[None, :])) & 1)[take]
    return np.packbits(bits).tobytes()


def _packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out.append(257 - (j - i))
            out.append(data[i])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        j = max(j, i + 1)
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def write_tif(path: str, img: np.ndarray, compression: str = "lzw",
              predictor: bool = True, rows_per_strip: int = 6,
              tile: tuple[int, int] | None = None,
              byteorder: str = "<") -> None:
    """Write a one-channel uint8 or uint16 [H, W] image as TIFF:
    ``compression`` none, packbits, lzw or deflate (Adobe's code, 8), the
    horizontal predictor with ``predictor`` (not with none or packbits),
    strips of ``rows_per_strip`` rows or tiles of ``tile`` = (width,
    height), multiples of 16, in ``byteorder`` "<" (II) or ">" (MM)."""
    a = np.asarray(img)
    if a.ndim != 2 or a.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_tif: uint8 or uint16 [H, W], got "
                         f"{a.dtype} {a.shape}")
    if compression not in _CODES:
        raise ValueError(f"write_tif: compression {compression!r}")
    e = byteorder
    H, W = a.shape
    pred = predictor and compression in ("lzw", "deflate")
    if tile is not None:
        bw, bh = tile
        if bw % 16 or bh % 16:
            raise ValueError(f"write_tif: tile sides must be multiples of "
                             f"16, got {tile}")
        pad = np.zeros((-(-H // bh) * bh, -(-W // bw) * bw), a.dtype)
        pad[:H, :W] = a
        blocks = [pad[y:y + bh, x:x + bw] for y in range(0, H, bh)
                  for x in range(0, W, bw)]
    else:
        blocks = [a[y:y + rows_per_strip] for y in range(0, H,
                                                         rows_per_strip)]
    payloads = []
    for b in blocks:
        if pred:
            b = np.diff(b, axis=1, prepend=np.zeros((b.shape[0], 1),
                                                    b.dtype))
        raw = np.ascontiguousarray(b, b.dtype.newbyteorder(e)).tobytes()
        if compression == "lzw":
            raw = _lzw_encode(raw)
        elif compression == "deflate":
            raw = zlib.compress(raw, 6)
        elif compression == "packbits":
            raw = _packbits_encode(raw)
        payloads.append(raw)

    header = (b"II*\x00" if e == "<" else b"MM\x00*")
    body = bytearray()
    offsets = []
    pos = 8
    for p in payloads:
        offsets.append(pos + len(body))
        body += p
        if len(body) % 2:
            body += b"\x00"
    n_blocks = len(payloads)
    entries = [(_WIDTH, 3, [W]), (_HEIGHT, 3, [H]),
               (_BITS, 3, [8 * a.dtype.itemsize]),
               (_COMPRESSION, 3, [_CODES[compression]]),
               (_PHOTOMETRIC, 3, [1])]
    if tile is None:
        entries += [(_STRIP_OFFSETS, 4, offsets), (_SAMPLES, 3, [1]),
                    (_ROWS_PER_STRIP, 3, [rows_per_strip]),
                    (_STRIP_BYTES, 4, [len(p) for p in payloads]),
                    (_PLANAR, 3, [1])]
    else:
        entries += [(_SAMPLES, 3, [1]), (_PLANAR, 3, [1])]
    if pred:
        entries.append((_PREDICTOR, 3, [2]))
    if tile is not None:
        entries += [(_TILE_WIDTH, 3, [tile[0]]), (_TILE_LENGTH, 3, [tile[1]]),
                    (_TILE_OFFSETS, 4, offsets),
                    (_TILE_BYTES, 4, [len(p) for p in payloads])]
    entries.append((_SAMPLE_FORMAT, 3, [1]))
    entries.sort()
    ifd_off = pos + len(body)
    extra = bytearray()
    extra_off = ifd_off + 2 + 12 * len(entries) + 4
    ifd = bytearray(struct.pack(e + "H", len(entries)))
    for tag, typ, vals in entries:
        code, size = _TYPES[typ]
        raw = struct.pack(e + code * len(vals), *vals)
        if len(raw) <= 4:
            value = raw.ljust(4, b"\x00")
        else:
            value = struct.pack(e + "I", extra_off + len(extra))
            extra += raw
        ifd += struct.pack(e + "HHI", tag, typ, len(vals)) + value
    ifd += struct.pack(e + "I", 0)
    assert n_blocks == len(offsets)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(header + struct.pack(e + "I", ifd_off) + bytes(body)
                + bytes(ifd) + bytes(extra))
