"""Port ops vs ``rdpn6d_tpu.ops`` on the same seeded inputs.

Tolerances: the gather crops weight the same four taps in the same order
as the JAX gather crop, so they agree to float32 rounding (rtol 1e-6 of
the 0..255 / metre values); against the TPU path's matmul crop
(``crop_resize_mm``, Wy·img·Wxᵀ) the sum runs in another order, so
atol 1e-4 on 0..255 pixels and 1e-6 on ~1 m depths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdpn6d_tpu.ops import binning as jbin
from rdpn6d_tpu.ops import region as jreg
from rdpn6d_tpu.ops import resize as jres
from rdpn6d_tpu.ops import warp as jwarp
from rdpn6d_tpu_torch.ops import binning as tbin
from rdpn6d_tpu_torch.ops import region as treg
from rdpn6d_tpu_torch.ops import resize as tres
from rdpn6d_tpu_torch.ops import warp as twarp


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# centers/scales that cross every border, plus exact-half source coords
CROPS = [((80.0, 60.0), 96.0), ((3.0, 5.0), 50.0), ((150.0, 110.0), 70.0),
         ((80.5, 60.5), 64.0), ((80.0, 60.0), 250.0)]


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
@pytest.mark.parametrize("center,scale", CROPS)
def test_crop_resize_matches_jax_gather(center, scale, interp):
    rng = np.random.RandomState(0)
    img = (rng.rand(120, 160, 3) * 255).astype(np.float32)
    c = np.array(center, np.float32)
    ref = np.asarray(jwarp.crop_resize(jnp.asarray(img), jnp.asarray(c),
                                       scale, 32, interp))
    out = twarp.crop_resize(_t(img), _t(c), scale, 32, interp).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-4)
    # uint8 frames give the same crop as their float32 cast
    out_u8 = twarp.crop_resize(_t(img.astype(np.uint8)), _t(c), scale, 32,
                               interp).numpy()
    ref_u8 = np.asarray(jwarp.crop_resize(
        jnp.asarray(img.astype(np.uint8).astype(np.float32)),
        jnp.asarray(c), scale, 32, interp))
    np.testing.assert_allclose(out_u8, ref_u8, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
def test_crop_resize_frames_matches_jax_mm(interp):
    rng = np.random.RandomState(1)
    frames = (rng.rand(2, 120, 160, 3) * 255).astype(np.float32)
    depth = rng.uniform(0.5, 1.5, (2, 120, 160)).astype(np.float32)
    fidx = np.array([0, 1, 1, 0])
    centers = np.array([c for c, _ in CROPS[:4]], np.float32)
    scales = np.array([s for _, s in CROPS[:4]], np.float32)
    out = twarp.crop_resize_frames(_t(frames), _t(fidx), _t(centers),
                                   _t(scales), 32, interp).numpy()
    out_d = twarp.crop_resize_frames(_t(depth), _t(fidx), _t(centers),
                                     _t(scales), 32, interp).numpy()
    for i, f in enumerate(fidx):
        ref = np.asarray(jwarp.crop_resize_mm(
            jnp.asarray(frames[f]), jnp.asarray(centers[i]), scales[i], 32,
            precision="highest", interp=interp))
        np.testing.assert_allclose(out[i], ref, atol=1e-4)
        ref_d = np.asarray(jwarp.crop_resize_mm(
            jnp.asarray(depth[f]), jnp.asarray(centers[i]), scales[i], 32,
            precision="highest", interp=interp))
        np.testing.assert_allclose(out_d[i], ref_d, atol=1e-6)


def test_crop_affine():
    rng = np.random.RandomState(2)
    c = rng.uniform(0, 640, (6, 2)).astype(np.float32)
    s = rng.uniform(20, 400, 6).astype(np.float32)
    np.testing.assert_allclose(
        twarp.crop_affine(_t(c), _t(s), 256).numpy(),
        np.asarray(jwarp.crop_affine(jnp.asarray(c), jnp.asarray(s), 256)),
        rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("hw_in,hw_out", [((8, 8), (32, 32)),
                                          ((2, 3), (8, 12)),
                                          ((5, 7), (9, 4))])
def test_resizes_match_jax(hw_in, hw_out):
    rng = np.random.RandomState(3)
    x = rng.randn(2, *hw_in, 4).astype(np.float32)            # NHWC
    xt = _t(x.transpose(0, 3, 1, 2))                          # NCHW
    up = tres.upsample_bilinear_align_corners(xt, *hw_out).numpy()
    # torch derives the source position in float32 as dst*(in-1)/(out-1);
    # JAX's weights come from float64 (resize.py:28): ~1e-5 relative apart
    np.testing.assert_allclose(
        up.transpose(0, 2, 3, 1),
        np.asarray(jres.upsample_bilinear_align_corners(
            jnp.asarray(x), *hw_out)), rtol=1e-5, atol=1e-5)
    big = rng.randn(2, 4 * hw_in[0], 3 * hw_in[1], 3).astype(np.float32)
    dn = tres.downsample_nearest_torch(_t(big.transpose(0, 3, 1, 2)),
                                       *hw_in).numpy()
    np.testing.assert_array_equal(
        dn.transpose(0, 2, 3, 1),
        np.asarray(jres.downsample_nearest_torch(jnp.asarray(big), *hw_in)))


def test_expected_coord_from_bins():
    rng = np.random.RandomState(4)
    logits = (rng.randn(2, 8, 8, 65) * 3).astype(np.float32)
    np.testing.assert_allclose(
        tbin.expected_coord_from_bins(_t(logits), 64).numpy(),
        np.asarray(jbin.expected_coord_from_bins(jnp.asarray(logits), 64)),
        atol=1e-6)


def test_gather_region_fps():
    rng = np.random.RandomState(5)
    fps = rng.randn(3, 32, 3).astype(np.float32)
    ids = rng.randint(0, 32, (3, 16, 16))
    np.testing.assert_array_equal(
        treg.gather_region_fps(_t(fps), _t(ids)).numpy(),
        np.asarray(jreg.gather_region_fps(jnp.asarray(fps),
                                          jnp.asarray(ids))))
