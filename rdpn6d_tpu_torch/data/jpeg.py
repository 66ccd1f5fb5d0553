"""JPEG reading with numpy: the port's stand-in for ``cv2.imread`` on JPEG.

The JAX package reads BOP-PBR frames (``train_pbr/*/rgb/*.jpg``) and the
VOC/SUN background pool with OpenCV, which decodes JPEG with libjpeg-turbo;
the machine that runs the port on the card has neither OpenCV nor Pillow.
This module decodes what those files are: baseline (and extended
sequential) Huffman JPEG at 8 bits, 1 or 3 components, any sampling whose
factors divide the largest (4:4:4, 4:2:2, 4:2:0, ...), interleaved or
not, with or without restart markers, any image size. It follows
libjpeg-turbo's defaults step for step, so the pixels are OpenCV's:

- the ISLOW integer IDCT (``jidctint.c``: 13-bit constants, 2 pass-1
  bits), its output clamped to 0..255;
- "fancy" triangle upsampling of subsampled chroma (``jdsample.c``:
  h2v1, h1v2 and h2v2 with their alternating rounding biases, edges
  replicated), and box replication for other integral factors;
- the fixed-point YCbCr->RGB of ``jdcolor.c`` (16 fractional bits).

Progressive, lossless, hierarchical, arithmetic-coded and 12-bit files,
and 2- or 4-component ones, raise ``ValueError``: nothing is guessed.

Huffman decoding is a Python loop over symbols (a 16-bit lookup table and
a 32-bit window read at every bit position); the IDCT, upsampling and
colour conversion are numpy over whole planes. The loop is the cost: see
PERF.md for its milliseconds a frame.
"""

from __future__ import annotations

import re
import struct
from array import array
from functools import lru_cache

import numpy as np

SIGNATURE = b"\xff\xd8\xff"

# zig-zag position -> natural (row-major) index, padded with 63 so that a
# corrupt run length cannot index past the block (as libjpeg pads it)
_NATURAL = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
) + (63,) * 16

_SOF_REFUSED = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless",
    **dict.fromkeys((0xCD, 0xCE, 0xCF), "arithmetic-coded hierarchical"),
}
# the end of an entropy-coded segment: 0xFF not followed by a stuffed 0x00,
# a restart marker or a fill byte
_SEGMENT_END = re.compile(rb"\xff(?![\x00\xd0-\xd7\xff])")
_RESTART = re.compile(rb"\xff[\xd0-\xd7]")


@lru_cache(maxsize=64)
def _huffman_lut(counts: bytes, symbols: bytes) -> list[int]:
    """A 65536-entry table from a 16-bit lookahead to ``length << 8 |
    symbol``; 0 where no code matches (a corrupt stream). Cached: most
    files carry the same standard tables. Read only."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                raise ValueError("JPEG Huffman table is over-subscribed")
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _bit_windows(data: bytes) -> memoryview:
    """For every bit position p of ``data``, the 32 bits starting at p (zero
    past the end): one lookup gives a Huffman code and its extra bits."""
    b = np.frombuffer(data + bytes(8), np.uint8).astype(np.uint64)
    w40 = (b[:-4] << np.uint64(32)) | (b[1:-3] << np.uint64(24)) \
        | (b[2:-2] << np.uint64(16)) | (b[3:-1] << np.uint64(8)) | b[4:]
    shifts = np.arange(8, 0, -1, dtype=np.uint64)
    win = (w40[:, None] >> shifts[None, :]) & np.uint64(0xFFFFFFFF)
    return memoryview(np.ascontiguousarray(win.astype(np.uint32).ravel()))


def _decode_blocks(win, pos: int, n_blocks: int, block_comp: list[int],
                   block_base: list[int], dc_luts: list, ac_luts: list,
                   coef: array) -> int:
    """Huffman-decode ``n_blocks`` blocks from bit ``pos`` (one restart
    interval: the DC predictors start at 0) into ``coef`` in natural order;
    returns the bit position after the last."""
    pred = [0] * len(dc_luts)
    natural = _NATURAL
    for i in range(n_blocks):
        c = block_comp[i]
        base = block_base[i]
        v = win[pos]
        e = dc_luts[c][v >> 16]
        n = e >> 8
        if not n:
            raise ValueError("JPEG data: bad Huffman code")
        s = e & 255
        if s:
            d = (v >> (32 - n - s)) & ((1 << s) - 1)
            if d < (1 << (s - 1)):
                d -= (1 << s) - 1
            pred[c] += d
        pos += n + s
        coef[base] = pred[c]
        ac = ac_luts[c]
        k = 1
        while k < 64:
            v = win[pos]
            e = ac[v >> 16]
            n = e >> 8
            if not n:
                raise ValueError("JPEG data: bad Huffman code")
            s = e & 15
            if s:
                k += (e >> 4) & 15
                d = (v >> (32 - n - s)) & ((1 << s) - 1)
                if d < (1 << (s - 1)):
                    d -= (1 << s) - 1
                coef[base + natural[k]] = d
                pos += n + s
                k += 1
            else:
                pos += n
                if (e & 255) != 0xF0:
                    break                       # end of block
                k += 16                         # a run of 16 zeros
    return pos


# ISLOW IDCT (jidctint.c): FIX(x) = round(x * 2**13)
_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961,
 _F2053, _F2562, _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299,
                            15137, 16069, 16819, 20995, 25172)


def _idct_1d(x: list[np.ndarray], shift: int) -> list[np.ndarray]:
    """One pass of jidctint.c's 8-point IDCT over int64 arrays; the
    outputs descaled by ``shift`` bits (round half up)."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _F1175
    tmp0 = tmp0 * _F0298
    tmp1 = tmp1 * _F2053
    tmp2 = tmp2 * _F3072
    tmp3 = tmp3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4
    half = 1 << (shift - 1)
    outs = (t10 + tmp3, t11 + tmp2, t12 + tmp1, t13 + tmp0,
            t13 - tmp0, t12 - tmp1, t11 - tmp2, t10 - tmp3)
    return [(o + half) >> shift for o in outs]


def _idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """[n, 64] quantized coefficients (natural order) -> [n, 8, 8] uint8
    samples: dequantize, columns then rows, +128 and clamp."""
    x = (coef.astype(np.int64) * qtable.astype(np.int64)).reshape(-1, 8, 8)
    cols = _idct_1d([x[:, r, :] for r in range(8)],
                    _CONST_BITS - _PASS1_BITS)        # each [n, 8 cols]
    ws = np.stack(cols, axis=1)                       # [n, row, col]
    rows = _idct_1d([ws[:, :, c] for c in range(8)],
                    _CONST_BITS + _PASS1_BITS + 3)    # each [n, 8 rows]
    out = np.stack(rows, axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _upsample(plane: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of a [h, w] component plane (already cut
    to its own size) by integral factors: the triangle filters for 2 on
    an axis with the other 1 or 2 (plane wider than 2 for h2), box
    replication otherwise."""
    p = plane.astype(np.int32)
    h, w = p.shape
    if (fy, fx) == (1, 2) and w > 2:                  # h2v1_fancy_upsample
        left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        out = np.stack([(3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2],
                       axis=2).reshape(h, 2 * w)
    elif (fy, fx) == (2, 1):                          # h1v2_fancy_upsample
        up = np.concatenate([p[:1], p[:-1]], axis=0)
        down = np.concatenate([p[1:], p[-1:]], axis=0)
        out = np.stack([(3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2],
                       axis=1).reshape(2 * h, w)
    elif (fy, fx) == (2, 2) and w > 2:                # h2v2_fancy_upsample
        up = np.concatenate([p[:1], p[:-1]], axis=0)
        down = np.concatenate([p[1:], p[-1:]], axis=0)
        rows = np.stack([3 * p + up, 3 * p + down], axis=1).reshape(2 * h, w)
        left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
        right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
        out = np.stack([(3 * rows + left + 8) >> 4,
                        (3 * rows + right + 7) >> 4],
                       axis=2).reshape(2 * h, 2 * w)
    else:
        out = np.repeat(np.repeat(p, fy, axis=0), fx, axis=1)
    return out.astype(np.uint8)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's fixed-point conversion: Cr->R and Cb->B rounded table
    entries, G from the summed unrounded terms shifted right."""
    one_half = 1 << 15
    fix = lambda v: int(v * 65536 + 0.5)              # noqa: E731
    yi = y.astype(np.int64)
    cbi = cb.astype(np.int64) - 128
    cri = cr.astype(np.int64) - 128
    r = yi + ((fix(1.40200) * cri + one_half) >> 16)
    g = yi + ((-fix(0.34414) * cbi + one_half - fix(0.71414) * cri) >> 16)
    b = yi + ((fix(1.77200) * cbi + one_half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, where: str = "<bytes>") -> np.ndarray:
    """The decoded image: [H, W] uint8 for one component, [H, W, 3] uint8
    RGB for three. ``where`` names the source in errors."""
    if data[:3] != SIGNATURE:
        raise ValueError(f"not a JPEG file: {where}")
    qtables: dict[int, np.ndarray] = {}
    dc_tabs: dict[int, list[int]] = {}
    ac_tabs: dict[int, list[int]] = {}
    frame = None
    comps: list[dict] = []
    restart = 0
    jfif = False
    adobe_transform = None
    coef: array | None = None
    pos = 2
    ended = False
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG marker expected at byte {pos}: {where}")
        marker = data[pos + 1]
        if marker == 0xFF:                            # fill byte
            pos += 1
            continue
        if marker == 0xD9:                            # EOI
            ended = True
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if pos + 4 > len(data):
            raise ValueError(f"truncated JPEG: {where}")
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        if len(body) != length - 2:
            raise ValueError(f"truncated JPEG segment: {where}")
        pos += 2 + length
        if marker in _SOF_REFUSED:
            raise ValueError(f"{_SOF_REFUSED[marker]} JPEG is not read "
                             f"(baseline or extended sequential Huffman "
                             f"only, ROADMAP queue 1 item 17): {where}")
        if marker == 0xCC:
            raise ValueError(f"arithmetic-coded JPEG is not read (ROADMAP "
                             f"queue 1 item 17): {where}")
        if marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xDB:                          # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 64 * (pq + 1)
                vals = np.frombuffer(body[i + 1:i + 1 + n],
                                     ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int32)
                table[list(_NATURAL[:64])] = vals
                qtables[tq] = table
                i += 1 + n
        elif marker == 0xC4:                          # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                n = sum(counts)
                lut = _huffman_lut(counts, body[i + 17:i + 17 + n])
                (ac_tabs if tc else dc_tabs)[th] = lut
                i += 17 + n
        elif marker == 0xDD:                          # DRI
            restart = struct.unpack(">H", body[:2])[0]
        elif marker in (0xC0, 0xC1):                  # SOF0 / SOF1
            precision, height, width, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"{precision}-bit JPEG is not read (8-bit "
                                 f"only; ROADMAP queue 1 item 17): {where}")
            if nf not in (1, 3):
                raise ValueError(f"JPEG with {nf} components is not read "
                                 f"(gray or 3-component colour): {where}")
            if height == 0 or width == 0:
                raise ValueError(f"JPEG without a height (DNL) or width is "
                                 f"not read: {where}")
            for c in range(nf):
                cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                              "tq": tq})
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            offset = 0
            for c in comps:
                if hmax % c["h"] or vmax % c["v"]:
                    raise ValueError(f"JPEG sampling factors that do not "
                                     f"divide the largest are not read: "
                                     f"{where}")
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
                c["w"] = -(-width * c["h"] // hmax)
                c["h_px"] = -(-height * c["v"] // vmax)
                c["offset"] = offset
                offset += c["bw"] * c["bh"] * 64
            frame = (height, width, hmax, vmax, mcux, mcuy)
            coef = array("i", bytes(4 * offset))
        elif marker == 0xDA:                          # SOS
            if frame is None:
                raise ValueError(f"JPEG scan before its frame header: "
                                 f"{where}")
            ns = body[0]
            sel = []
            for i in range(ns):
                cid, tables = body[1 + 2 * i], body[2 + 2 * i]
                ci = next((k for k, c in enumerate(comps) if c["id"] == cid),
                          None)
                if ci is None:
                    raise ValueError(f"JPEG scan names an unknown "
                                     f"component {cid}: {where}")
                comps[ci]["q"] = qtables.get(comps[ci]["tq"])
                sel.append((ci, tables >> 4, tables & 15))
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, ahal) != (0, 63, 0):
                raise ValueError(f"JPEG scan is not sequential (progressive "
                                 f"refinement; ROADMAP queue 1 item 17): "
                                 f"{where}")
            end = _SEGMENT_END.search(data, pos)
            if end is None:
                raise ValueError(f"truncated JPEG: its scan has no end: "
                                 f"{where}")
            end = end.start()
            _decode_scan(data[pos:end], frame, comps, sel, restart, dc_tabs,
                         ac_tabs, coef, where)
            pos = end
    if coef is None or not ended:
        raise ValueError(f"truncated JPEG (no frame or no end of image): "
                         f"{where}")
    return _reconstruct(frame, comps, coef, jfif, adobe_transform, where)


def _decode_scan(scan: bytes, frame: tuple, comps: list[dict],
                 sel: list[tuple[int, int, int]], restart: int,
                 dc_tabs: dict, ac_tabs: dict, coef: array,
                 where: str) -> None:
    """One scan's entropy-coded data (restart markers included) into
    ``coef``. An interleaved scan codes MCUs of each component's h x v
    blocks; a one-component scan codes that component's blocks in raster
    order, without the MCU padding."""
    height, width, hmax, vmax, mcux, mcuy = frame
    bases, owners = [], []
    if len(sel) == 1:
        c = comps[sel[0][0]]
        nbx, nby = -(-c["w"] // 8), -(-c["h_px"] // 8)
        grid = (np.arange(nby)[:, None] * c["bw"] + np.arange(nbx)[None, :])
        bases.append((c["offset"] + 64 * grid).reshape(-1, 1))
        owners.append(np.zeros_like(bases[-1]))
        per_mcu = 1
    else:
        for j, (ci, _, _) in enumerate(sel):
            c = comps[ci]
            my, mx, v, h = np.meshgrid(np.arange(mcuy), np.arange(mcux),
                                       np.arange(c["v"]), np.arange(c["h"]),
                                       indexing="ij")
            blk = (my * c["v"] + v) * c["bw"] + mx * c["h"] + h
            bases.append((c["offset"] + 64 * blk).reshape(mcuy * mcux, -1))
            owners.append(np.full_like(bases[-1], j))
        per_mcu = sum(b.shape[1] for b in bases)
    base = np.concatenate(bases, axis=1).reshape(-1).tolist()
    owner = np.concatenate(owners, axis=1).reshape(-1).tolist()
    n_mcus = len(base) // per_mcu
    try:
        dc = [dc_tabs[td] for _, td, _ in sel]
        ac = [ac_tabs[ta] for _, _, ta in sel]
    except KeyError:
        raise ValueError(f"JPEG scan uses an undefined Huffman table: "
                         f"{where}") from None
    # restart intervals: each starts byte-aligned with fresh DC predictors
    segments = _RESTART.split(scan) if restart else [scan]
    interval = restart or n_mcus
    n_intervals = -(-n_mcus // interval)
    if len(segments) < n_intervals:
        raise ValueError(f"truncated JPEG scan ({len(segments)} of "
                         f"{n_intervals} restart intervals): {where}")
    payload, starts = [], []
    size = 0
    for seg in segments[:n_intervals]:
        seg = seg.replace(b"\xff\x00", b"\xff")
        starts.append(8 * size)
        payload.append(seg)
        size += len(seg)
    win = _bit_windows(b"".join(payload))
    for r in range(n_intervals):
        lo = r * interval * per_mcu
        hi = min(n_mcus, (r + 1) * interval) * per_mcu
        try:
            _decode_blocks(win, starts[r], hi - lo, owner[lo:hi],
                           base[lo:hi], dc, ac, coef)
        except IndexError:
            raise ValueError(f"truncated JPEG scan: {where}") from None


def _reconstruct(frame: tuple, comps: list[dict], coef: array, jfif: bool,
                 adobe_transform: int | None, where: str) -> np.ndarray:
    """Coefficients -> the image: IDCT per component, each plane cut to
    its own size and upsampled to the frame's, then colour conversion as
    libjpeg decides it (JFIF or Adobe transform 1: YCbCr; Adobe transform
    0 or component ids R, G, B: RGB as stored)."""
    height, width, hmax, vmax, _, _ = frame
    allc = np.frombuffer(coef, np.int32)
    planes = []
    for c in comps:
        if c.get("q") is None:
            raise ValueError(f"JPEG component {c['id']} has no scan or no "
                             f"quantization table: {where}")
        n = c["bw"] * c["bh"]
        blocks = _idct_islow(
            allc[c["offset"]:c["offset"] + 64 * n].reshape(n, 64), c["q"])
        plane = blocks.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(8 * c["bh"], 8 * c["bw"])[:c["h_px"], :c["w"]]
        plane = _upsample(plane, vmax // c["v"], hmax // c["h"])
        planes.append(plane[:height, :width])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    ids = tuple(c["id"] for c in comps)
    if jfif:
        ycc = True
    elif adobe_transform is not None:
        ycc = adobe_transform != 0
    else:
        ycc = ids != (ord("R"), ord("G"), ord("B"))
    if ycc:
        return _ycc_to_rgb(*planes)
    return np.stack(planes, axis=-1)


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file decoded: [H, W] uint8 (gray) or [H, W, 3] uint8 RGB. A
    missing file raises FileNotFoundError; a file this reader does not
    read raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, path)
