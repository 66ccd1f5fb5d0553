"""The port's JPEG reader (``data/jpeg.py``) and encoder
(``data/synthetic.encode_jpeg``) against OpenCV, which decodes JPEG with
libjpeg-turbo (ISLOW IDCT, fancy upsampling).

Files come from ``cv2.imwrite`` at qualities 50, 75 and 95 with 4:2:0,
4:2:2 and 4:4:4 chroma (and 4:1:1 and 4:4:0, which the reader also
takes), gray, restart intervals, optimized Huffman tables, and sizes that
are not multiples of an MCU. Tolerance: none; every case decodes bit for
bit as ``cv2.imread`` does. The port's encoder's files read the same in
both. Progressive, arithmetic-coded and 12-bit files are refused.
"""

import os

import cv2
import numpy as np
import pytest

from rdpn6d_tpu_torch.data import image, jpeg, png, tif
from rdpn6d_tpu_torch.data.synthetic import encode_jpeg, write_jpeg

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _picture(h, w, seed=0, noise=20.0):
    """Smooth colour gradients with noise and a few hard edges: most DCT
    coefficients nonzero at high quality, long zero runs at low."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([127 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 11.0)
                    for c in range(3)], -1)
    img[h // 3:h // 2, w // 4:w // 2] = (250, 10, 128)
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_write(path, rgb, quality, flags=()):
    img = rgb if rgb.ndim == 2 else rgb[..., ::-1]
    assert cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                   *flags])


def _cv2_read(path):
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return img if img.ndim == 2 else np.ascontiguousarray(img[..., ::-1])


CASES = [(q, s, (37, 53)) for q in (50, 75, 95)
         for s in ("420", "422", "444")] + [
    (90, "411", (40, 70)), (90, "440", (33, 21)),
    (75, "420", (480, 640)), (75, "444", (1, 1)), (95, "420", (17, 9)),
    (95, "422", (8, 16)), (60, "420", (16, 33))]


@pytest.mark.parametrize("quality,sampling,hw", CASES,
                         ids=[f"q{q}-{s}-{h}x{w}" for q, s, (h, w) in CASES])
def test_reader_matches_cv2(tmp_path, quality, sampling, hw):
    path = str(tmp_path / "a.jpg")
    _cv2_write(path, _picture(*hw, seed=quality),
               quality, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    got, want = jpeg.read_jpeg(path), _cv2_read(path)
    assert got.dtype == np.uint8 and got.shape == want.shape == hw + (3,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["gray", "restart", "restart_gray",
                                  "optimized", "restart_every_mcu"])
def test_reader_matches_cv2_stream_variants(tmp_path, kind):
    """Gray (one component, one non-interleaved scan), restart intervals
    (the DC predictors reset at each marker), optimized Huffman tables."""
    path = str(tmp_path / "a.jpg")
    img = _picture(45, 61, seed=3)
    flags = []
    if "gray" in kind:
        img = np.ascontiguousarray(img[..., 1])
    if kind.startswith("restart"):
        flags = [cv2.IMWRITE_JPEG_RST_INTERVAL,
                 1 if kind == "restart_every_mcu" else 3]
    if kind == "optimized":
        flags = [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    _cv2_write(path, img, 80, flags)
    data = open(path, "rb").read()
    if kind.startswith("restart"):
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    got, want = jpeg.read_jpeg(path), _cv2_read(path)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # IMREAD_COLOR of a gray JPEG copies it to three channels
    rgb = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                       cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(image.imread_rgb(path), rgb)


@pytest.mark.parametrize("subsample", [True, False])
@pytest.mark.parametrize("hw", [(480, 640), (31, 45), (5, 3)])
def test_encoder_files_read_equal(tmp_path, hw, subsample):
    """The port's encoder: colour (4:2:0 or 4:4:4) and gray files that
    OpenCV and the reader decode to the same pixels, close to the source
    at quality 95 (a picture with little noise: 4:2:0 halves chroma)."""
    rgb = _picture(*hw, seed=hw[0], noise=2.0)
    for img in (rgb, np.ascontiguousarray(rgb[..., 0])):
        path = str(tmp_path / "e.jpg")
        write_jpeg(path, img, quality=95, subsample=subsample)
        got, want = jpeg.read_jpeg(path), _cv2_read(path)
        np.testing.assert_array_equal(got, want)
        err = np.abs(got.astype(int) - img.astype(int))
        if min(hw) >= 16 or not subsample or img.ndim == 2:
            # (a 5x3 red block's chroma halved is far off, as it should be)
            assert err.mean() < 4.0, err.mean()


def test_refusals(tmp_path):
    """Progressive (written by OpenCV), arithmetic-coded and 12-bit (the
    frame header of a baseline file changed), truncated and non-JPEG
    input raise ValueError; a missing file FileNotFoundError."""
    path = str(tmp_path / "p.jpg")
    _cv2_write(path, _picture(32, 40), 80, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive.*queue 1 item 17"):
        jpeg.read_jpeg(path)
    base = encode_jpeg(_picture(32, 40))
    sof = base.index(b"\xff\xc0")
    arith = base[:sof + 1] + b"\xc9" + base[sof + 2:]
    with pytest.raises(ValueError, match="arithmetic.*queue 1 item 17"):
        jpeg.decode_jpeg(arith)
    deep = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    with pytest.raises(ValueError, match="12-bit.*queue 1 item 17"):
        jpeg.decode_jpeg(deep)
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(base[:len(base) // 2])
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(FileNotFoundError):
        jpeg.read_jpeg(str(tmp_path / "absent.jpg"))


def test_imread_rgb_dispatches_by_signature(tmp_path):
    """``data/image.py`` picks the codec by the file's first bytes, not
    its name: a PNG named .jpg, a JPEG named .png and a gray TIFF named
    .png (refused before TIFF frames were read) read as OpenCV reads
    them; other bytes are refused."""
    rgb = _picture(20, 30, seed=5)
    png_as_jpg = str(tmp_path / "a.jpg")
    png.write_png(png_as_jpg, rgb)
    jpg_as_png = str(tmp_path / "b.png")
    write_jpeg(jpg_as_png, rgb)
    tif_as_png = str(tmp_path / "c.png")
    tif.write_tif(tif_as_png, rgb[..., 1])
    for path in (png_as_jpg, jpg_as_png, tif_as_png):
        want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(image.imread_rgb(path), want)
    other = str(tmp_path / "d.gif")
    with open(other, "wb") as f:
        f.write(b"GIF89a" + bytes(60))
    with pytest.raises(ValueError, match="neither PNG, JPEG nor TIFF"):
        image.imread_rgb(other)
    assert os.path.getsize(jpg_as_png) < os.path.getsize(png_as_jpg)
