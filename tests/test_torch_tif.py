"""The port's TIFF reader (``data/tif.py``) against OpenCV.

``imread_rgb`` is held to ``cv2.imread(path, IMREAD_COLOR)`` then BGR->RGB,
and ``read_tif`` to ``cv2.imread(path, IMREAD_UNCHANGED)``, on files that
``cv2.imwrite`` writes (strips: no compression, LZW and Deflate with the
horizontal predictor, PackBits; 8- and 16-bit) and on files the port's
``write_tif`` writes (tiles, big-endian, each compression), which OpenCV
reads too. Tolerance: none, the arrays are equal byte for byte. A 16-bit
plane read in colour is v >> 8, as OpenCV cuts it (185 gives 0, not the
rounded 1). One exception is recorded, not copied: OpenCV reads a 16-bit
tiled file whose width is not a multiple of the tile width with wrong
values (zeros, mostly) in the last tile column after its first row; the
port returns the stored pixels there, which ``IMREAD_UNCHANGED`` also
gives.
"""

import cv2
import numpy as np
import pytest

from rdpn6d_tpu_torch.data import image, tif

COMPRESSIONS = {"none": 1, "lzw": 5, "deflate": 8, "packbits": 32773}


def gray_frame(h, w, dtype, seed=0):
    """A smooth gray frame with noise, as a camera gives (the predictor
    and LZW see runs and small differences)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    v = (0.5 + 0.3 * np.sin(xx / 23.0) + 0.15 * np.cos(yy / 17.0)
         + rng.normal(0, 0.02, (h, w))).clip(0, 1)
    top = np.iinfo(dtype).max
    return np.round(v * top).astype(dtype)


def cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("compression", sorted(COMPRESSIONS))
def test_reads_what_opencv_writes(tmp_path, compression, dtype):
    img = gray_frame(61, 83, dtype, seed=3)
    path = str(tmp_path / "frame.tif")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_TIFF_COMPRESSION,
                                   COMPRESSIONS[compression]])
    assert image.image_format(path) == "tif"
    np.testing.assert_array_equal(tif.read_tif(path),
                                  cv2.imread(path, cv2.IMREAD_UNCHANGED))
    got = image.imread_rgb(path)
    assert got.dtype == np.uint8 and got.shape == (61, 83, 3)
    np.testing.assert_array_equal(got, cv2_rgb(path))
    assert tif.image_size(path) == (83, 61)


def test_itodd_sized_frame_as_opencv_writes_it(tmp_path):
    """A 960x1280 uint8 frame as OpenCV writes it by default: LZW with
    the horizontal predictor in 160 strips of 6 rows."""
    img = gray_frame(960, 1280, np.uint8, seed=5)
    path = str(tmp_path / "000000.tif")
    assert cv2.imwrite(path, img)
    _, tags = tif._read_ifd(open(path, "rb").read(), path)
    assert (tags[259], tags[317], len(tags[273])) == ((5,), (2,), 160)
    np.testing.assert_array_equal(image.imread_rgb(path), cv2_rgb(path))


def test_sixteen_bits_in_colour_are_the_high_byte(tmp_path):
    v = np.array([[37, 185, 255, 256, 300, 32767, 32768, 65535]],
                 np.uint16).repeat(3, axis=0)
    path = str(tmp_path / "v.tif")
    assert cv2.imwrite(path, v)
    got = image.imread_rgb(path)[0, :, 0]
    np.testing.assert_array_equal(got, cv2_rgb(path)[0, :, 0])
    np.testing.assert_array_equal(got, [0, 0, 0, 1, 1, 127, 128, 255])


@pytest.mark.parametrize("byteorder", ["<", ">"])
@pytest.mark.parametrize("compression", sorted(COMPRESSIONS))
@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_reads_its_own_files_as_opencv(tmp_path, layout, compression,
                                       byteorder):
    path = str(tmp_path / "w.tif")
    tile = (32, 16) if layout == "tiles" else None
    for dtype, (h, w) in ((np.uint8, (45, 70)), (np.uint16, (45, 64)),
                          (np.uint16, (45, 70))):
        img = gray_frame(h, w, dtype, seed=w)
        tif.write_tif(path, img, compression, tile=tile,
                      rows_per_strip=7, byteorder=byteorder)
        np.testing.assert_array_equal(tif.read_tif(path), img)
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        ours = image.imread_rgb(path)
        if tile and dtype == np.uint16 and w % tile[0]:
            # OpenCV's colour read of such a file garbles the partial tile
            # column below its first row (module docstring): the rest
            # agrees, and the port keeps the stored pixels' high bytes
            cut = w - w % tile[0]
            np.testing.assert_array_equal(ours[:, :cut],
                                          cv2_rgb(path)[:, :cut])
            np.testing.assert_array_equal(ours[..., 0], img >> 8)
            continue
        np.testing.assert_array_equal(ours, cv2_rgb(path))


def test_lzw_round_trip_across_table_resets():
    """Long noisy input fills the code table (12-bit codes, clears)."""
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, 40000).astype(np.uint8).tobytes() \
        + bytes(5000) + bytes(range(256)) * 20
    enc = tif._lzw_encode(data)
    assert tif._lzw_decode(enc, "<test>") == data
    assert tif._lzw_decode(tif._lzw_encode(b""), "<test>") == b""
    assert tif._packbits_decode(tif._packbits_encode(data),
                                len(data)) == data


def test_refusals(tmp_path):
    path = str(tmp_path / "x.tif")
    rgb = gray_frame(8, 8, np.uint8)[..., None].repeat(3, axis=2)
    assert cv2.imwrite(path, rgb)
    with pytest.raises(ValueError, match="one-channel.*3 samples"):
        tif.read_tif(path)
    assert cv2.imwrite(path, np.zeros((8, 8), np.float32))
    with pytest.raises(ValueError, match="32 bits of sample format 3"):
        tif.read_tif(path)
    tif.write_tif(path, gray_frame(8, 8, np.uint8), "none")
    data = bytearray(open(path, "rb").read())
    # rewrite the compression tag's value to JPEG (7)
    at = bytes(data).index((259).to_bytes(2, "little") + b"\x03\x00")
    data[at + 8:at + 10] = (7).to_bytes(2, "little")
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="compression 7"):
        tif.read_tif(path)
    for sig in tif.BIGTIFF_SIGNATURES:
        open(path, "wb").write(sig + bytes(12))
        with pytest.raises(ValueError, match="BigTIFF"):
            tif.read_tif(path)
        with pytest.raises(ValueError, match="BigTIFF"):
            image.imread_rgb(path)
    open(path, "wb").write(b"GIF89a" + bytes(12))
    with pytest.raises(ValueError, match="neither PNG, JPEG nor TIFF"):
        image.imread_rgb(path)
    with pytest.raises(FileNotFoundError):
        image.imread_rgb(str(tmp_path / "none.tif"))
    with pytest.raises(ValueError, match="uint8 or uint16"):
        tif.write_tif(path, np.zeros((4, 4), np.float32))
