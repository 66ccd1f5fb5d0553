"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against
their plain versions on the card (the ROI crop and the label kernels also
at T-LESS's 540x720 and ITODD's 960x1280 frames), one lm13 train step on
the card, the
entry points' default device, colour aug and lmo's two label paths card
against CPU, the image codecs on the card's machine, and the RANSAC-Kabsch
kernel against its plain version and on ``test.use_pnp``'s served path.

They skip where there is no card. This file imports neither jax nor the
JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rdpn6d_tpu_torch.ops import cuda_build
from rdpn6d_tpu_torch.ops.gt_labels import gt_labels, gt_labels_plain
from rdpn6d_tpu_torch.ops.int8_conv import (
    STAGES,
    _int8_conv_launch,
    bn_relu_quantize,
    bn_relu_quantize_plain,
    int8_conv,
    int8_conv_plain,
    int8_conv_plan,
    quantize_act,
    quantize_act_plain,
)
from rdpn6d_tpu_torch.ops.min_dist import min_dist2, min_dist2_plain
from rdpn6d_tpu_torch.ops.region import region_label, region_label_plain
from rdpn6d_tpu_torch.ops.roi_crop import roi_crop, roi_crop_plain
from rdpn6d_tpu_torch.ops.surface_labels import (
    surface_labels,
    surface_labels_plain,
)
from rdpn6d_tpu_torch.ops.warp import crop_resize_frames


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m,d", [
    (1, 7, 5, 3), (1, 300, 700, 3), (3, 129, 1000, 5), (16, 4096, 4096, 3),
    # ragged around a block's 1024 a-rows, the 256-row stage chunk and the
    # 4-row step, split (small B) and unsplit (large B)
    (1, 1023, 255, 3), (2, 1024, 256, 3), (1, 1025, 257, 3),
    (3, 2049, 513, 3), (1, 1, 1, 3), (5, 1, 6, 3), (1, 300, 5001, 3),
    (600, 33, 130, 3),
    # phase 9's largest per-object launch
    (8, 3000, 3000, 3)])
def test_min_dist2_kernel_matches_plain(card, B, n, m, d):
    g = torch.Generator().manual_seed(n + m)
    a = torch.randn(B, n, d, generator=g).to(card)
    b = torch.randn(B, m, d, generator=g).to(card)
    before = cuda_build.LAUNCHES.get("min_dist2", 0)
    out = min_dist2(a, b)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["min_dist2"] == before + 1
    ref = min_dist2_plain(a, b)
    # direct form on both sides; FMA contraction moves a few ulps
    scale = float((a * a).sum(-1).max() + (b * b).sum(-1).max())
    assert float((out - ref).abs().max()) <= 1e-6 * scale
    if B == 1:
        flat = min_dist2(a[0], b[0])
        assert flat.shape == (n,)
        torch.testing.assert_close(flat, out[0], rtol=0, atol=0)


def _nonfinite(case, B, n, m):
    """a [B,n,3], b [B,m,3] with non-finite values in the last batch item
    only: a NaN in one b-row (every row of that item NaN), a NaN in one
    a-row (that row NaN), b all NaN, or a at -inf and b at +inf in one row
    each (that a-row +inf)."""
    g = torch.Generator().manual_seed(n + m)
    a = torch.randn(B, n, 3, generator=g)
    b = torch.randn(B, m, 3, generator=g)
    if case == "nan_b_row":
        b[-1, m // 2, 1] = float("nan")
    elif case == "nan_a_row":
        a[-1, n // 3, 2] = float("nan")
    elif case == "all_nan_b":
        b[-1] = float("nan")
    else:
        a[-1, n // 3] = float("-inf")
        b[-1, m // 2] = float("inf")
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nan_b_row", "nan_a_row", "all_nan_b",
                                  "inf"])
@pytest.mark.parametrize("B,n,m", [(2, 300, 700), (1, 300, 5001),
                                   (600, 33, 130)])
def test_min_dist2_kernel_nonfinite_matches_plain(card, case, B, n, m):
    """NaN and inf land where the plain version puts them, split or not. A
    kernel that reduced with fminf would drop the NaN distances."""
    a, b = (t.to(card) for t in _nonfinite(case, B, n, m))
    out = min_dist2(a, b)
    ref = min_dist2_plain(a, b)
    torch.cuda.synchronize()
    assert torch.equal(out.isnan(), ref.isnan())
    assert torch.equal(out.isposinf(), ref.isposinf())
    assert bool(ref.isnan().any() or ref.isposinf().any())
    fin = ref.isfinite()
    assert bool(fin[:-1].all())
    if fin.any():
        fa, fb = (t[t.isfinite().all(-1)] for t in (a, b))
        scale = float((fa * fa).sum(-1).max() + (fb * fb).sum(-1).max())
        assert float((out[fin] - ref[fin]).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
def test_min_dist2_split_equals_unsplit_bitwise(card):
    """One ROI alone splits b over blocks; the same ROI inside a batch large
    enough to fill the card does not. The per-pair arithmetic is written
    out and the min is exact, so the two agree to the bit."""
    from rdpn6d_tpu_torch.ops.min_dist import launch_plan

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    big = 4 * sms
    g = torch.Generator().manual_seed(5)
    a = (torch.randn(big, 300, 3, generator=g) * 0.05 + 0.9).to(card)
    b = (torch.randn(big, 4096, 3, generator=g) * 0.05 + 0.9).to(card)
    assert launch_plan(1, 300, 4096, 3, sms).splits > 1
    assert launch_plan(big, 300, 4096, 3, sms).splits == 1
    alone = min_dist2(a[17:18].contiguous(), b[17:18].contiguous())
    batched = min_dist2(a, b)
    torch.cuda.synchronize()
    assert torch.equal(alone[0], batched[17])


@pytest.mark.cuda
def test_min_dist2_kernel_refuses_bad_input(card):
    a = torch.randn(4, 3, device=card)
    with pytest.raises(TypeError):
        min_dist2(a.half(), a.half())
    with pytest.raises(ValueError):
        min_dist2(a, torch.randn(5, 3))           # CPU b
    with pytest.raises(ValueError):
        min_dist2(torch.randn(4, 9, device=card),
                  torch.randn(5, 9, device=card))       # D > kernel max


@pytest.mark.cuda
def test_adi_on_card_matches_cpu(card):
    from rdpn6d_tpu_torch.evaluation.pose_error import adi

    rng = np.random.RandomState(0)
    q, _ = np.linalg.qr(rng.randn(6, 3, 3))
    R = torch.from_numpy((q * np.sign(np.linalg.det(q))[:, None, None])
                         .astype(np.float32))
    t = torch.from_numpy(rng.uniform(0.5, 1.0, (6, 3)).astype(np.float32))
    pts = torch.from_numpy((rng.rand(6, 2000, 3) * 0.1).astype(np.float32))
    before = cuda_build.LAUNCHES.get("min_dist2", 0)
    on_card = adi(R.to(card), t.to(card), R.flip(0).to(card), t.to(card),
                  pts.to(card)).cpu()
    assert cuda_build.LAUNCHES["min_dist2"] == before + 1
    torch.testing.assert_close(on_card, adi(R, t, R.flip(0), t, pts),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_default_device_is_cuda(card):
    from rdpn6d_tpu_torch.utils.device import resolve_device

    assert resolve_device(None).type == "cuda"


def _label_inputs(B, H, W, K, seed):
    g = torch.Generator().manual_seed(seed)
    xyz = (torch.rand(B, H, W, 3, generator=g) - 0.5) * 0.12
    xyz[torch.rand(B, H, W, generator=g) < 0.3] = 0.0
    fps = (torch.rand(B, K, 3, generator=g) - 0.5) * 0.1
    q, _ = torch.linalg.qr(torch.randn(B, 3, 3, generator=g))
    rot = q * torch.linalg.det(q).sign()[:, None, None]
    ext = torch.rand(B, 3, generator=g) * 0.15 + 0.05
    return xyz, fps, rot.contiguous(), ext


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,K", [(1, 7, 5, 3), (3, 33, 31, 17),
                                     (2, 64, 64, 64), (24, 64, 64, 32),
                                     # keypoints in one, two and four tiles
                                     # of 64; a ragged last block
                                     (2, 9, 11, 1), (2, 33, 31, 65),
                                     (3, 64, 64, 96), (2, 17, 19, 200)])
def test_region_label_kernel_matches_plain(card, B, H, W, K):
    xyz, fps, rot, ext = (t.to(card) for t in _label_inputs(B, H, W, K,
                                                            H + K))
    before = cuda_build.LAUNCHES.get("region_label", 0)
    reg, coord = region_label(xyz, fps, rot, ext)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["region_label"] == before + 1
    ref_reg, ref_coord = region_label_plain(xyz, fps, rot, ext)
    # the kernel rounds the distances exactly as the plain version (no
    # FMA contraction), so the ids agree everywhere
    assert torch.equal(reg, ref_reg)
    assert float((coord - ref_coord).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_region_label_kernel_refuses_bad_input(card):
    xyz, fps, rot, ext = (t.to(card) for t in _label_inputs(2, 8, 8, 65, 0))
    with pytest.raises(ValueError):
        region_label(xyz, fps[:, :0], rot, ext)         # no keypoints
    with pytest.raises(ValueError):
        region_label(xyz, fps[:, :4].cpu(), rot, ext)   # mixed devices


@pytest.mark.cuda
def test_tie_across_the_keypoint_tile_on_card(card):
    """Keypoints 63 and 64 (either side of the kernel's 64-keypoint tile)
    and 5 and 130 equidistant from a pixel: the three label kernels take
    the lower index, as the plain versions do."""
    K = 131
    fps = torch.full((1, K, 3), -1.0)
    fps[0, :, 2] -= torch.arange(K, dtype=torch.float32) * 0.01
    fps[0, 63], fps[0, 64] = torch.tensor([0.1, 0.0, 0.0]), \
        torch.tensor([-0.1, 0.0, 0.0])
    fps[0, 5], fps[0, 130] = torch.tensor([0.0, 0.05, 0.6]), \
        torch.tensor([0.0, -0.05, 0.6])
    xyz = torch.zeros(1, 1, 2, 3)
    xyz[0, 0, 0] = torch.tensor([0.0, 0.0, -0.3])
    xyz[0, 0, 1] = torch.tensor([0.0, 0.0, 0.6])
    rot, ext = torch.eye(3)[None], torch.ones(1, 3)
    reg, _ = region_label(*(t.to(card) for t in (xyz, fps, rot, ext)))
    assert reg.cpu()[0, 0].tolist() == [64, 6]
    args = (torch.ones(1, 1, 2, dtype=torch.uint8), None, xyz,
            torch.tensor([[0.0, 0.0]]), torch.tensor([1.0]), fps, rot, ext)
    got = gt_labels(*(None if t is None else t.to(card) for t in args), 1)
    ref = gt_labels_plain(*args, 1)
    assert torch.equal(got["roi_region"].cpu(), ref["roi_region"])
    assert ref["roi_region"].item() == 64
    # the depth surface: a 1 m tap on the principal point, R = I, t = (0,
    # 0, 1.3), so xyz = (0, 0, -0.3), equidistant from keypoints 63 and 64
    cam = torch.tensor([[[100.0, 0.0, 0.0], [0.0, 100.0, 0.0],
                         [0.0, 0.0, 1.0]]])
    args = (torch.ones(1, 1, 1), torch.zeros(1, dtype=torch.long),
            torch.ones(1, 1, 1, dtype=torch.uint8), None, cam,
            torch.tensor([[0.0, 0.0]]), torch.tensor([1.0]), fps, rot,
            torch.tensor([[0.0, 0.0, 1.3]]), ext)
    got = surface_labels(*(None if t is None else t.to(card) for t in args),
                         1)
    ref = surface_labels_plain(*args, 1)
    assert torch.equal(got["roi_region"].cpu(), ref["roi_region"])
    assert ref["roi_region"].item() == 64


def _gt_inputs(B, h, w, K, seed, masks, half):
    """Per-ROI GT maps (an elliptic object, a visib mask spilling past it,
    a trunc mask that differs), and crops that may run off the maps."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    c = torch.rand(B, 2, 1, 1, generator=g) * 0.4 + 0.3
    obj = ((xx - c[:, 0] * w) / (0.3 * w)) ** 2 \
        + ((yy - c[:, 1] * h) / (0.3 * h)) ** 2 < 1
    xyz = (torch.rand(B, h, w, 3, generator=g) - 0.5) * 0.12 * obj[..., None]
    visib = (obj | (torch.rand(B, h, w, generator=g) < 0.1)) \
        & (torch.rand(B, h, w, generator=g) < 0.9)
    trunc = visib & (torch.rand(B, h, w, generator=g) < 0.7)
    if masks == "packed":
        mask, trunc = visib.to(torch.uint8) | (trunc.to(torch.uint8) << 1), \
            None
    else:
        mask = visib.float()
        trunc = trunc.float() if masks == "trunc" else None
    center = torch.rand(B, 2, generator=g) * torch.tensor([w, h])
    scale = (torch.rand(B, generator=g) + 0.3) * max(h, w)
    _, fps, rot, ext = _label_inputs(B, 1, 1, K, seed)
    return (mask, trunc, xyz.half() if half else xyz, center, scale, fps,
            rot, ext)


@pytest.mark.cuda
@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("masks", ["packed", "trunc", "visib_only"])
@pytest.mark.parametrize("B,h,w,out,K", [(1, 7, 5, 3, 3),
                                         (3, 33, 31, 17, 17),
                                         (2, 100, 90, 33, 64),
                                         (24, 480, 640, 64, 32),
                                         (24, 540, 720, 64, 32),
                                         (24, 960, 1280, 64, 32),
                                         (2, 40, 30, 9, 1),
                                         (3, 50, 60, 17, 65),
                                         (2, 100, 90, 33, 96),
                                         (2, 60, 70, 13, 200)])
def test_gt_labels_kernel_matches_plain(card, B, h, w, out, K, masks, half):
    inp = [None if t is None else t.to(card)
           for t in _gt_inputs(B, h, w, K, h + K, masks, half)]
    if B == 2:      # every other source coordinate exactly on .5
        inp[3] = inp[3].round()
        inp[4] = torch.full_like(inp[4], out / 2)
    xyz_c = crop_resize_frames(inp[2].float(), torch.arange(B, device=card),
                               inp[3], inp[4], out, interp="nearest")
    d2 = ((xyz_c.double()[..., None, :] - inp[5].double()[:, None, None])
          ** 2).sum(-1).sort(-1).values
    tie = (d2[..., 1] - d2[..., 0]) <= 1e-6 * d2[..., 1] if K > 1 \
        else torch.zeros_like(d2[..., 0], dtype=torch.bool)
    for residual in (True, False):
        before = cuda_build.LAUNCHES.get("gt_labels", 0)
        got = gt_labels(*inp, out, residual=residual)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["gt_labels"] == before + 1
        ref = gt_labels_plain(*inp, out, residual=residual)
        for k in ("roi_mask_visib", "roi_mask_obj", "roi_mask_trunc"):
            assert torch.equal(got[k], ref[k]), k
        differ = got["roi_region"] != ref["roi_region"]
        assert not bool((differ & ~tie).any())
        same = ~differ
        assert float((got["roi_xyz"] - ref["roi_xyz"]).abs()[same].max()) \
            <= 1e-5


@pytest.mark.cuda
def test_crop_source_coords_match_cpu(card):
    """The crops' source coordinates round alike on the card and the CPU
    at any out size (the fused kernel computes them the same way), so a
    nearest tap does not depend on the device."""
    from rdpn6d_tpu_torch.ops.warp import _src_coords

    g = torch.Generator().manual_seed(0)
    scales = torch.rand(4096, generator=g) * 600 + 1
    centers = torch.rand(4096, 2, generator=g) * 640
    for out in (3, 33, 64, 100):
        on_card = _src_coords(centers.to(card), scales.to(card), out)
        for a, b in zip(on_card, _src_coords(centers, scales, out)):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_gt_labels_kernel_refuses_bad_input(card):
    inp = [None if t is None else t.to(card)
           for t in _gt_inputs(2, 8, 8, 65, 0, "packed", True)]
    with pytest.raises(ValueError):
        gt_labels(*inp[:5], inp[5][:, :0], *inp[6:], 8)  # no keypoints
    inp[5] = inp[5][:, :4]
    with pytest.raises(ValueError):
        gt_labels(*inp[:5], inp[5].cpu(), *inp[6:], 8)  # mixed devices
    with pytest.raises(ValueError):                     # packed + trunc
        gt_labels(inp[0], inp[0].float(), *inp[2:], 8)
    with pytest.raises(TypeError):
        gt_labels(inp[0], None, inp[2].bfloat16(), *inp[3:], 8)


def _surface_inputs(B, F, h, w, K, seed, masks):
    """Depth frames (a ~0.7 m surface with 5% holes), each ROI's frame and
    full-frame masks (visib, a trunc that differs), its K, a crop that may
    run off the frame, a GT pose whose origin sits on the surface at the
    crop's centre, keypoints, R and extents: ``surface_labels``' arguments
    before out_res."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    depth = 0.6 + 0.2 * torch.rand(F, 1, 1, generator=g) \
        + 0.05 * torch.sin(xx / 7 + yy / 11)
    depth = depth * (torch.rand(F, h, w, generator=g) > 0.05)
    frame_idx = torch.randint(0, F, (B,), generator=g)
    visib = torch.rand(B, h, w, generator=g) < 0.7
    trunc = visib & (torch.rand(B, h, w, generator=g) < 0.7)
    if masks == "packed":
        mask, trunc = visib.to(torch.uint8) | (trunc.to(torch.uint8) << 1), \
            None
    else:
        mask = visib.float()
        trunc = trunc.float() if masks == "trunc" else None
    f = 1.2 * max(h, w)
    cam = torch.tensor([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]]) \
        .repeat(B, 1, 1)
    cam[:, :2, 2] += torch.rand(B, 2, generator=g) - 0.5
    center = torch.rand(B, 2, generator=g) * torch.tensor([w, h])
    scale = (torch.rand(B, generator=g) + 0.3) * max(h, w)
    z = 0.7
    trans = torch.stack([(center[:, 0] - cam[:, 0, 2]) * z / f,
                         (center[:, 1] - cam[:, 1, 2]) * z / f,
                         torch.full((B,), z)], -1)
    _, fps, rot, ext = _label_inputs(B, 1, 1, K, seed)
    return (depth, frame_idx, mask, trunc, cam, center, scale, fps, rot,
            trans, ext)


@pytest.mark.cuda
@pytest.mark.parametrize("masks", ["packed", "trunc", "visib_only"])
@pytest.mark.parametrize("B,F,h,w,out,K", [(1, 1, 7, 5, 3, 3),
                                           (3, 2, 33, 31, 17, 17),
                                           (2, 1, 100, 90, 33, 64),
                                           (24, 8, 480, 640, 64, 32),
                                           (24, 8, 540, 720, 64, 32),
                                           (24, 8, 960, 1280, 64, 32),
                                           (2, 2, 40, 30, 9, 1),
                                           (3, 2, 50, 60, 17, 65),
                                           (2, 1, 100, 90, 33, 96),
                                           (2, 2, 60, 70, 13, 200)])
def test_surface_labels_kernel_matches_plain(card, B, F, h, w, out, K,
                                             masks):
    """The kernel rounds every op of the taps, the back-projection, the
    rotations and the distances as the plain version does: masks and ids
    equal, coordinates within 1e-6 (the design gives them bit for bit)."""
    inp = [None if t is None else t.to(card)
           for t in _surface_inputs(B, F, h, w, K, h + K, masks)]
    if B == 2:      # every other source coordinate exactly on .5
        inp[5] = inp[5].round()
        inp[6] = torch.full_like(inp[6], out / 2)
    for residual in (True, False):
        before = cuda_build.LAUNCHES.get("surface_labels", 0)
        got = surface_labels(*inp, out, residual=residual)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["surface_labels"] == before + 1
        ref = surface_labels_plain(*inp, out, residual=residual)
        for k in ("roi_mask_visib", "roi_mask_obj", "roi_mask_trunc"):
            assert torch.equal(got[k], ref[k]), k
        assert got["roi_mask_obj"] is got["roi_mask_visib"]
        assert torch.equal(got["roi_region"], ref["roi_region"])
        assert float((got["roi_xyz"] - ref["roi_xyz"]).abs().max()) <= 1e-6
        assert bool((ref["roi_mask_obj"] > 0).any())


@pytest.mark.cuda
def test_surface_labels_kernel_refuses_bad_input(card):
    inp = [None if t is None else t.to(card)
           for t in _surface_inputs(2, 1, 8, 8, 65, 0, "packed")]
    with pytest.raises(ValueError):                     # no keypoints
        surface_labels(*inp[:7], inp[7][:, :0], *inp[8:], 8)
    with pytest.raises(ValueError):                     # mixed devices
        surface_labels(*inp[:7], inp[7].cpu(), *inp[8:], 8)
    with pytest.raises(ValueError):                     # packed + trunc
        surface_labels(*inp[:3], inp[2].float(), *inp[4:], 8)
    with pytest.raises(TypeError):
        surface_labels(inp[0].half(), *inp[1:], 8)
    with pytest.raises(TypeError):
        surface_labels(inp[0], inp[1].int(), *inp[2:], 8)


@pytest.mark.cuda
def test_lm13_train_step_on_card(card, tmp_path):
    import itertools

    from rdpn6d_tpu_torch.configs import lm13
    from rdpn6d_tpu_torch.data.synthetic import dummy_grouped_inputs
    from rdpn6d_tpu_torch.engine.trainer import Trainer
    from rdpn6d_tpu_torch.models import RDPN, init_weights

    cfg = lm13.get_config().apply_opts(
        ['head.init="fan_in"', 'backbone.pretrained=""',
         "solver.ims_per_batch=4", "train.log_period=1000",
         f'train.output_dir="{tmp_path}"'])
    frames, rois = dummy_grouped_inputs(cfg, n_frames=2, rois_per_frame=2,
                                        im_hw=(480, 640), ship_xyz=True,
                                        focal=572.0)
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(0))
    trainer = Trainer(cfg, model, total_iters=2)
    seen = []
    cuda_build.reset_launches()
    trainer.train(itertools.repeat({"frames": frames, "rois": rois}),
                  step_hook=lambda it, m: seen.append(
                      {k: float(v) for k, v in m.items()}))
    # the xyz-shipped labels go through the fused kernel
    assert cuda_build.LAUNCHES["gt_labels"] == 2
    assert cuda_build.LAUNCHES.get("region_label", 0) == 0
    assert len(seen) == 2
    assert all(np.isfinite(list(m.values())).all() for m in seen)
    assert all(m["grad_norm"] > 0 for m in seen)


@pytest.mark.cuda
def test_pose_evaluator_card_matches_cpu(card):
    """Per-object errors on the card (ADI through ``min_dist2``, one launch
    an object) against the CPU: ADD/ADI/te within 1e-6 m, re within 1e-3
    degrees (a few float32 ulps of the cosine at rotation errors of ~1
    degree), proj within 1e-3 px."""
    from rdpn6d_tpu_torch.evaluation.evaluator import PoseEvaluator

    rng = np.random.RandomState(0)
    models = {o: ((rng.rand(3000, 3) - 0.5) * 0.15).astype(np.float32)
              for o in ("a", "b", "c")}
    n = 24
    names = [("a", "b", "c")[i % 3] for i in range(n)]
    q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    R_gt = q * np.sign(np.linalg.det(q))[:, None, None]
    q, _ = np.linalg.qr(np.eye(3) + 0.15 * rng.randn(n, 3, 3))
    R_est = (q * np.sign(np.linalg.det(q))[:, None, None]) @ R_gt
    t_gt = np.c_[rng.uniform(-0.1, 0.1, (n, 2)), rng.uniform(0.6, 1, n)]
    t_est = t_gt + rng.randn(n, 3) * 0.01
    K = np.broadcast_to(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0],
                                  [0, 0, 1]]), (n, 3, 3))
    out = {}
    for dev in (card, "cpu"):
        ev = PoseEvaluator(models=models, diameters={o: 0.26 for o in models},
                           n_gts={"a": 9, "b": 8, "c": 8}, device=dev)
        ev.process_batch(names, R_est, t_est, R_gt, t_gt, K)
        before = cuda_build.LAUNCHES.get("min_dist2", 0)
        out[str(dev)] = (ev.compute_errors(), ev.evaluate())
        if dev == card:
            assert cuda_build.LAUNCHES["min_dist2"] == before + 3
    (e_card, r_card), (e_cpu, r_cpu) = out.values()
    tol = {"ad": 1e-6, "add": 1e-6, "adi": 1e-6, "te": 1e-6, "re": 1e-3,
           "proj": 1e-3}
    for obj in e_cpu:
        for k, t in tol.items():
            a, b = e_card[obj][k], e_cpu[obj][k]
            np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
            fin = np.isfinite(b)
            np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=t,
                                       err_msg=f"{obj} {k}")
    assert r_card["per_obj"].keys() == r_cpu["per_obj"].keys()


@pytest.mark.cuda
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png_round_trip_on_card_machine(card, tmp_path, filter_type):
    """The PNG codec on the card's host: frames written there (every row
    filter) read back to the arrays written."""
    from rdpn6d_tpu_torch.data import png

    rng = np.random.RandomState(filter_type)
    rgb = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    depth = rng.randint(0, 65536, (480, 640)).astype(np.uint16)
    for name, img in (("rgb", rgb), ("depth", depth)):
        path = str(tmp_path / f"{name}.png")
        png.write_png(path, img, filter_type)
        np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(png.imread_rgb(str(tmp_path / "rgb.png")),
                                  rgb)


AUG_NAMES = ["code", "aae", "aae_weak", "lm", "roi10d"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", AUG_NAMES)
def test_color_augment_card_matches_cpu(card, name):
    """Each named pipeline on 24 crops of 64x64 under the same draws, on
    the card and on the CPU, within 1e-3 on the 0..255 scale (float32 in
    other orders; ``lighting``'s eigenvector signs follow the port's
    convention on both)."""
    from rdpn6d_tpu_torch.data.augment import (
        color_augment,
        draw_aug_params,
        get_aug_pipeline,
    )

    ops = get_aug_pipeline(name)
    gen = torch.Generator().manual_seed(3)
    img = torch.rand(24, 64, 64, 3, generator=gen) * 255.0
    params = draw_aug_params(ops, 24, gen, size=(64, 64))
    cpu = color_augment(img, params, ops)
    on_card = color_augment(img.to(card), [{k: v.to(card) for k, v in
                                           p.items()} for p in params], ops)
    assert float((on_card.cpu() - cpu).abs().max()) <= 1e-3
    assert not torch.equal(cpu, img)


@pytest.mark.cuda
@pytest.mark.parametrize("ship_xyz", [True, False])
def test_lmo_train_labels_card_matches_cpu(card, ship_xyz):
    """``preprocess_rois_grouped(train=True)`` with lmo's data settings
    (the "code" colour aug at 0.8, draws injected) on the card and on the
    CPU: with GT xyz (the real split, ``gt_labels``) and without (the PBR
    split, the depth surface through ``surface_labels``); the kernel is
    launched once and ``region_label`` never; masks equal, region ids on
    >= 0.999 of the pixels, coordinates within 1e-5, the RGB within
    1e-3 / 255."""
    from rdpn6d_tpu_torch.config import Config
    from rdpn6d_tpu_torch.data.augment import draw_aug_params, get_aug_pipeline
    from rdpn6d_tpu_torch.data.pipeline import preprocess_rois_grouped
    from rdpn6d_tpu_torch.data.synthetic import dummy_grouped_inputs

    cfg = Config().apply_opts(["data.color_aug_prob=0.8",
                               'data.color_aug_type="code"'])
    frames, rois = dummy_grouped_inputs(cfg, n_frames=2, rois_per_frame=3,
                                        seed=4, im_hw=(480, 640), focal=572.0,
                                        ship_xyz=ship_xyz)
    gen = torch.Generator().manual_seed(2)
    B, S = len(rois["frame_idx"]), cfg.data.input_res
    aug = {"apply": torch.rand(B, generator=gen) < 0.8,
           "ops": draw_aug_params(get_aug_pipeline("code"), B, gen, (S, S))}
    bbox = torch.from_numpy(rois["bbox"])
    cs = (0.5 * (bbox[:, :2] + bbox[:, 2:]),
          1.5 * (bbox[:, 2:] - bbox[:, :2]).amax(-1))
    outs = []
    for dev in ("cpu", card):
        cuda_build.reset_launches()
        out = preprocess_rois_grouped(
            cfg, {k: torch.from_numpy(v).to(dev) for k, v in frames.items()},
            {k: torch.from_numpy(v).to(dev) for k, v in rois.items()},
            train=True, center_scale=tuple(t.to(dev) for t in cs),
            aug_params={"apply": aug["apply"].to(dev),
                        "ops": [{k: v.to(dev) for k, v in p.items()}
                                for p in aug["ops"]]})
        outs.append({k: v.cpu() for k, v in out.items()})
    kernel = "gt_labels" if ship_xyz else "surface_labels"
    assert cuda_build.LAUNCHES.get(kernel, 0) == 1
    assert cuda_build.LAUNCHES.get("region_label", 0) == 0
    assert cuda_build.LAUNCHES.get("roi_crop", 0) == 1
    cpu, gpu = outs
    for k in ("roi_mask_visib", "roi_mask_trunc", "roi_mask_obj"):
        assert torch.equal(cpu[k], gpu[k]), k
    same = cpu["roi_region"] == gpu["roi_region"]
    assert same.float().mean() >= 0.999
    assert float((cpu["roi_xyz"] - gpu["roi_xyz"])[same].abs().max()) <= 1e-5
    assert float((cpu["roi_img"][..., :3] - gpu["roi_img"][..., :3])
                 .abs().max()) <= 1e-3 / 255.0


# a 20x28 4:2:0 JPEG with a restart marker every 2 MCUs, written by
# libjpeg-turbo (OpenCV, quality 70), and the MD5 of the pixels OpenCV
# decodes from it: the reader is integer arithmetic, so every machine
# must give these bytes
_LIBJPEG_FILE = bytes.fromhex(
    "ffd8ffe000104a46494600010100000100010000ffdb0043000a07070807060a0808080b"
    "0a0a0b0e18100e0d0d0e1d15161118231f2524221f2221262b372f262934292122304131"
    "34393b3e3e3e252e4449433c48373d3e3bffdb0043010a0b0b0e0d0e1c10101c3b282228"
    "3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b3b"
    "3b3b3b3b3b3b3b3b3b3b3b3b3b3bffc00011080014001c03012200021101031101ffc400"
    "1f0000010501010101010100000000000000000102030405060708090a0bffc400b51000"
    "02010303020403050504040000017d010203000411051221314106135161072271143281"
    "91a1082342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a"
    "434445464748494a535455565758595a636465666768696a737475767778797a83848586"
    "8788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9faffc400"
    "1f0100030101010101010101010000000000000102030405060708090a0bffc400b51100"
    "020102040403040705040400010277000102031104052131061241510761711322328108"
    "144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a3536373839"
    "3a434445464748494a535455565758595a636465666768696a737475767778797a828384"
    "85868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4"
    "c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9faffdd00"
    "040002ffda000c03010002110311003f00eb6f2fd64b73f3000f4f7ae03c44a6676c0c9c"
    "1e95746b0256dbbce31c0cd4c96cb7801ea09eb5be1b12b0b1e491cb3c1b9cfda238fb2b"
    "3649c363033d31d2bb5b028b6880c817f0ff00ebd30e8c23e42818e47e75109bc9f90638"
    "f5cf35c188c33c54b9d1ea431d1a51e53fffd0e3ad2e24372885b23762bd03c3c03c6a5b"
    "92d8a28ae0ccf4aba1eb515fb837afe24581c01d8571b7080ccddb9e80d1457d0658bf74"
    "7c8625b55343ffd9")
_LIBJPEG_PIXELS_MD5 = "c006a6e87358595eb3bb17fe753b1c41"


@pytest.mark.cuda
def test_jpeg_reader_on_card_machine(card, tmp_path):
    """On the machine without OpenCV: libjpeg's file decodes to OpenCV's
    pixels, and the encoder's files decode close to their source."""
    import hashlib

    from rdpn6d_tpu_torch.data.image import imread_rgb
    from rdpn6d_tpu_torch.data.jpeg import decode_jpeg
    from rdpn6d_tpu_torch.data.synthetic import write_jpeg

    got = decode_jpeg(_LIBJPEG_FILE)
    assert got.shape == (20, 28, 3)
    assert hashlib.md5(got.tobytes()).hexdigest() == _LIBJPEG_PIXELS_MD5
    yy, xx = np.mgrid[0:48, 0:64]
    img = np.stack([128 + 60 * np.sin(xx / 9.0 + c) for c in range(3)],
                   -1).astype(np.uint8)
    write_jpeg(str(tmp_path / "e.jpg"), img, quality=95)
    back = imread_rgb(str(tmp_path / "e.jpg"))
    assert np.abs(back.astype(int) - img).mean() < 2.0


def _act_inputs(B, C, H, W, mode, dtype, seed):
    """Post-BN/ReLU-like activations with channels of unlike ranges, and
    the scalar absmax and SmoothQuant factors a mode needs."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, C, H, W, generator=g) \
        * torch.rand(C, generator=g)[None, :, None, None] * 3
    x = x.clamp_min(-0.3).to(dtype)
    amax = t = None
    if mode == "static":
        amax = x.float().abs().amax() * 0.9        # some inputs clip
    elif mode == "per_channel":
        t = torch.rand(C, generator=g) + 0.25
        amax = (x.float().abs().amax(dim=(0, 2, 3)) / t).amax()
    return x, amax, t


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dynamic", "static", "per_channel"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,C,H,W", [
    (16, 320, 64, 64), (16, 256, 64, 64),            # lm13's head at B=16
    (16, 64, 64, 64), (16, 128, 32, 32), (16, 256, 16, 16), (16, 512, 8, 8),
    (3, 8, 7, 33), (2, 16, 5, 9), (1, 40, 3, 65)])   # ragged
def test_quantize_act_kernel_matches_plain(card, mode, dtype, B, C, H, W):
    x, amax, t = _act_inputs(B, C, H, W, mode, dtype, B * C + H)
    x, amax, t = (None if v is None else v.to(card) for v in (x, amax, t))
    before = cuda_build.LAUNCHES.get("quantize_act", 0)
    xq, sx = quantize_act(x, mode, amax, t)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["quantize_act"] == before + 1
    rq, rs = quantize_act_plain(x, mode, amax, t)
    assert xq.shape == (B, H, W, -(-C // 32) * 32)
    assert torch.equal(sx, rs)
    assert torch.equal(xq, rq)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dynamic", "static", "per_channel"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_act_half_way_values_round_to_even(card, mode, dtype):
    """x / s = k + 0.5 exactly (s = 1: an absmax of 127; per channel t = 2
    and x = 2k + 1): the kernel rounds half to even, as jnp.round does."""
    k = torch.arange(-127, 127, dtype=torch.float32)
    half = k + 0.5
    if mode == "per_channel":
        half = 2 * half
    x = torch.cat([half, torch.full((1,), 127.0 * (2 if mode == "per_channel"
                                                   else 1))])
    x = x.reshape(1, 1, 1, -1).expand(2, 3, 2, -1).contiguous().to(dtype)
    amax = None if mode == "dynamic" else torch.tensor(127.0)
    t = torch.full((3,), 2.0) if mode == "per_channel" else None
    x, amax, t = (None if v is None else v.to(card) for v in (x, amax, t))
    xq, sx = quantize_act(x, mode, amax, t)
    rq, rs = quantize_act_plain(x, mode, amax, t)
    torch.cuda.synchronize()
    assert torch.equal(sx, rs) and bool((rs == 1.0).all())
    assert torch.equal(xq, rq)
    got = xq[0, 0, :254, 0].cpu().to(torch.int32)
    want = torch.round(k + 0.5).clamp(-127, 127).to(torch.int32)
    assert torch.equal(got, want)


def _same(a, b) -> bool:
    """Equal, NaN where the other is NaN (its payload aside)."""
    return torch.equal(a.isnan(), b.isnan()) \
        and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dynamic", "static", "per_channel"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_kernels_nan_as_plain(card, mode, dtype):
    """A NaN (and a NaN with its sign bit set) in sample 0: the dynamic
    scale and so the whole output of that sample is NaN, and a NaN
    quantizes to 0, as in the plain version and XLA; sample 1 is
    untouched."""
    x, amax, t = _act_inputs(2, 40, 9, 11, mode, dtype, 5)
    x[0, 3, 4, 5] = float("nan")
    x[0, 38, 0, 10] = -float("nan")
    g = torch.Generator().manual_seed(6)
    wq = torch.zeros(24, 3, 3, 64, dtype=torch.int8)
    wq[..., :40] = torch.randint(-127, 128, (24, 3, 3, 40), generator=g,
                                 dtype=torch.int8)
    sw = torch.rand(24, generator=g) * 0.002 + 1e-4
    x, amax, t, wq, sw = (None if v is None else v.to(card)
                          for v in (x, amax, t, wq, sw))
    xq, sx = quantize_act(x, mode, amax, t)
    rq, rs = quantize_act_plain(x, mode, amax, t)
    out = int8_conv(xq, sx, wq, sw, 1, 1, dtype)
    ref = int8_conv_plain(rq, rs, wq, sw, 1, 1, dtype)
    torch.cuda.synchronize()
    assert torch.equal(xq, rq) and _same(sx, rs) and _same(out, ref)
    assert int(xq[0, 4, 5, 3]) == 0 and int(xq[0, 0, 10, 38]) == 0
    assert bool(sx[1].isfinite()) and bool(out[1].isfinite().all())
    if mode == "dynamic":
        assert bool(sx[0].isnan()) and bool(out[0].isnan().all())
    else:
        assert bool(out.isfinite().all())


def _conv_inputs(B, H, W, C, N, k, seed):
    g = torch.Generator().manual_seed(seed)
    cp = -(-C // 32) * 32
    xq = torch.zeros(B, H, W, cp, dtype=torch.int8)
    xq[..., :C] = torch.randint(-127, 128, (B, H, W, C), generator=g,
                                dtype=torch.int8)
    wq = torch.zeros(N, k, k, cp, dtype=torch.int8)
    wq[..., :C] = torch.randint(-127, 128, (N, k, k, C), generator=g,
                                dtype=torch.int8)
    sx = torch.rand(B, generator=g) * 0.02 + 1e-3
    sw = torch.rand(N, generator=g) * 0.002 + 1e-4
    return xq, sx, wq, sw


# (B, H, W, C_in, N, k, stride, pad)
INT8_CONV_SHAPES = [
    (16, 64, 64, 320, 256, 3, 1, 1), (16, 64, 64, 256, 256, 3, 1, 1),
    (16, 64, 64, 64, 64, 3, 1, 1), (16, 64, 64, 64, 128, 3, 2, 1),
    (16, 64, 64, 64, 128, 1, 2, 0), (16, 32, 32, 128, 256, 3, 2, 1),
    (16, 16, 16, 256, 512, 1, 2, 0), (16, 8, 8, 512, 512, 3, 1, 1),
    # ragged M and N, Cin not a multiple of 32
    (3, 7, 9, 8, 24, 3, 1, 1), (1, 5, 5, 16, 130, 3, 2, 1),
    (2, 11, 6, 40, 8, 1, 1, 0), (1, 1, 1, 320, 1, 3, 1, 1),
    # K not a multiple of the 128-byte slab (K = 32), N of 192 and 257 (a
    # second tile of one column), tiles across samples at B = 3 with N =
    # 512, the head at B = 1 (too few tiles for 256-wide ones)
    (2, 9, 13, 32, 40, 1, 1, 0), (2, 12, 12, 64, 192, 3, 1, 1),
    (2, 12, 12, 64, 257, 3, 1, 1), (3, 7, 9, 96, 512, 3, 1, 1),
    (1, 64, 64, 320, 256, 3, 1, 1), (1, 9, 10, 40, 64, 3, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W,C,N,k,stride,pad", INT8_CONV_SHAPES)
def test_int8_conv_kernel_matches_plain(card, out_dtype, B, H, W, C, N, k,
                                        stride, pad):
    xq, sx, wq, sw = (v.to(card) for v in _conv_inputs(B, H, W, C, N, k,
                                                       H * C + N))
    before = cuda_build.LAUNCHES.get("int8_conv", 0)
    out = int8_conv(xq, sx, wq, sw, stride, pad, out_dtype)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["int8_conv"] == before + 1
    ref = int8_conv_plain(xq, sx, wq, sw, stride, pad, out_dtype)
    assert out.shape == ref.shape and out.dtype == out_dtype
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bn", sorted(STAGES))
@pytest.mark.parametrize("B,H,W,C,N,k,stride,pad", [
    (16, 64, 64, 320, 256, 3, 1, 1), (3, 7, 9, 8, 24, 3, 1, 1),
    (2, 9, 13, 32, 40, 1, 1, 0), (2, 12, 12, 64, 257, 3, 1, 1),
    (1, 5, 5, 16, 130, 3, 2, 1)])
def test_int8_conv_every_plan_matches_plain(card, out_dtype, bn, B, H, W, C,
                                            N, k, stride, pad):
    """Each implemented tile width, forced, is bit-equal to the plain
    version."""
    xq, sx, wq, sw = (v.to(card) for v in _conv_inputs(B, H, W, C, N, k,
                                                       H * C + N))
    Ho, Wo = ((s + 2 * pad - k) // stride + 1 for s in (H, W))
    plan = int8_conv_plan(B, Ho, Wo, N, k * k * xq.shape[3], bn=bn)
    out = _int8_conv_launch(xq, sx, wq, sw, stride, pad, out_dtype, plan)
    ref = int8_conv_plain(xq, sx, wq, sw, stride, pad, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_int8_conv_build_spills_nothing(card):
    """ptxas keeps every conv instantiation's accumulators in registers:
    no spill stores or loads in the build log."""
    _, built = cuda_build.load("int8_conv")
    usage = {name: u for name, u in cuda_build.ptxas_usage(built.log).items()
             if "int8_conv_kernel" in name}
    assert len(usage) == 2 * len(STAGES)
    for name, u in usage.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0, (name, u)


@pytest.mark.cuda
@pytest.mark.parametrize("static", [False, True, "per_channel"])
def test_int8_conv_module_quantizes_as_on_cpu(card, static):
    """The module's weight and activation scales on the card are the CPU's
    bit for bit (CUDA divides by a Python scalar through its reciprocal;
    the port divides by a tensor), and so is the output."""
    from rdpn6d_tpu_torch.models.quant import Int8Conv, calibrate_quant

    x, _, _ = _act_inputs(4, 40, 9, 11, "dynamic", torch.float32, 3)
    g = torch.Generator().manual_seed(7)
    cpu = Int8Conv(40, 24, 3, 2, 1, static)
    with torch.no_grad():
        cpu.weight.copy_(torch.randn(24, 40, 3, 3, generator=g) * 0.1)
    gpu = Int8Conv(40, 24, 3, 2, 1, static)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(card)
    if static:
        calibrate_quant(cpu, [x])
        calibrate_quant(gpu, [x.to(card)])
        assert torch.equal(gpu.act_amax.cpu(), cpu.act_amax)
    for a, b in zip(gpu.quantized(), cpu.quantized()):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.cpu(), b)
    with torch.no_grad():
        assert torch.equal(gpu(x.to(card)).cpu(), cpu(x))


@pytest.mark.cuda
def test_int8_kernels_cpu_tensors_never_launch(card):
    xq, sx, wq, sw = _conv_inputs(1, 5, 5, 8, 4, 3, 0)
    x = torch.randn(1, 8, 5, 5)
    before = dict(cuda_build.LAUNCHES)
    int8_conv(xq, sx, wq, sw, 1, 1, torch.float32)
    quantize_act(x, "dynamic")
    assert {k: cuda_build.LAUNCHES.get(k, 0) for k in before} == before
    assert cuda_build.LAUNCHES.get("int8_conv", 0) == before.get(
        "int8_conv", 0)


@pytest.mark.cuda
def test_int8_kernels_refuse_bad_input(card):
    xq, sx, wq, sw = (v.to(card) for v in _conv_inputs(1, 5, 5, 8, 4, 3, 0))
    with pytest.raises(ValueError):
        int8_conv(xq[..., :16], sx, wq[..., :16], sw, 1, 1, torch.float32)
    with pytest.raises(ValueError):
        int8_conv(xq, sx, wq.cpu(), sw, 1, 1, torch.float32)
    with pytest.raises(ValueError):
        int8_conv(xq, sx, wq, sw, 1, 1, torch.float16)
    with pytest.raises(ValueError):
        quantize_act(torch.randn(1, 8, 5, 5, device=card), "static")


def _fused_inputs(B, C1, C2, H, W, mode, dtype, seed):
    """y [B,C1,H,W] and skip [B,C2,H,W] in ``dtype``, a BN's folded
    constants and the mode's amax and t, the static ones taken from the
    plain activation (some inputs clip)."""
    from rdpn6d_tpu_torch.models.norm import BatchNorm2d
    from rdpn6d_tpu_torch.ops.int8_conv import bn_relu_plain

    g = torch.Generator().manual_seed(seed)
    y = (torch.randn(B, C1, H, W, generator=g)
         * (torch.rand(C1, generator=g) * 3)[None, :, None, None]).to(dtype)
    skip = None if not C2 else torch.randn(B, C2, H, W, generator=g).clamp_min(
        0).to(dtype)
    bn = BatchNorm2d(C1)
    with torch.no_grad():
        bn.weight.copy_(torch.randn(C1, generator=g))
        bn.bias.copy_(torch.randn(C1, generator=g) * 0.5)
        bn.running_mean.copy_(torch.randn(C1, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(C1, generator=g) * 2 + 0.05)
    consts = bn.eval().folded()
    a = bn_relu_plain(y, *consts, skip).float()
    amax = t = None
    if mode == "static":
        amax = a.abs().amax() * 0.9
    elif mode == "per_channel":
        t = torch.rand(C1 + C2, generator=g) + 0.25
        amax = (a.abs().amax(dim=(0, 2, 3)) / t).amax() * 0.9
    return y, skip, consts, amax, t


def _on(card, *vs):
    return [None if v is None else v.to(card) for v in vs]


# (B, C1, C2, H, W): lm13's head at B = 16 (256 BN'd channels, and 256 +
# the 64 skip channels of rot_concat), the trunk's widest; channels not a
# multiple of 32, H W not a multiple of 8 (scalar loads) and of the 64-pixel
# tile, B = 1
FUSED_SHAPES = [(16, 256, 0, 64, 64), (16, 256, 64, 64, 64),
                (16, 512, 0, 8, 8), (3, 40, 8, 7, 33), (2, 72, 0, 6, 20),
                (1, 33, 31, 8, 8), (2, 24, 0, 5, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dynamic", "static", "per_channel"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,C1,C2,H,W", FUSED_SHAPES)
def test_bn_relu_quantize_kernel_matches_plain(card, mode, dtype, B, C1, C2,
                                               H, W):
    y, skip, consts, amax, t = _fused_inputs(B, C1, C2, H, W, mode, dtype,
                                             B * C1 + C2 + H)
    y, skip, amax, t = _on(card, y, skip, amax, t)
    consts = _on(card, *consts)
    before = cuda_build.LAUNCHES.get("bn_relu_quantize", 0)
    xq, sx = bn_relu_quantize(y, *consts, mode, amax, t, skip)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["bn_relu_quantize"] == before + 1
    rq, rs = bn_relu_quantize_plain(y, *consts, mode, amax, t, skip)
    assert xq.shape == (B, H, W, -(-(C1 + C2) // 32) * 32)
    assert torch.equal(sx, rs)
    assert torch.equal(xq, rq)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dynamic", "static", "per_channel"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_relu_quantize_nan_and_unaligned_as_plain(card, mode, dtype):
    """A NaN in y and one in the skip of sample 0: the dynamic scale is
    NaN there, a NaN quantizes to 0; y starting off a 16-byte boundary
    takes the scalar loads, bit-equal all the same."""
    y, skip, consts, amax, t = _fused_inputs(2, 40, 24, 8, 16, mode, dtype,
                                             9)
    y[0, 3, 2, 4] = float("nan")
    skip[0, 5, 7, 1] = -float("nan")
    y, skip, amax, t = _on(card, y, skip, amax, t)
    consts = _on(card, *consts)
    flat = torch.empty(y.numel() + 1, dtype=dtype, device=card)
    shifted = flat[1:].view(y.shape)
    shifted.copy_(y)
    for yy in (y, shifted):
        xq, sx = bn_relu_quantize(yy, *consts, mode, amax, t, skip)
        rq, rs = bn_relu_quantize_plain(y, *consts, mode, amax, t, skip)
        torch.cuda.synchronize()
        assert torch.equal(xq, rq) and _same(sx, rs)
        assert int(xq[0, 2, 4, 3]) == 0 and int(xq[0, 7, 1, 45]) == 0
        assert bool(sx[0].isnan()) == (mode == "dynamic")
        assert bool(sx[1].isfinite())


@pytest.mark.cuda
@pytest.mark.parametrize("static", [False, True, "per_channel"])
def test_int8_head_folds_and_matches_cpu(card, static):
    """A BN int8 head with a skip on the card: its int8 convs take the
    BN before them folded (``bn_relu_quantize``, one launch a conv and no
    ``quantize_act``), and each one's output equals a CPU copy of it on the
    card's inputs, bit for bit."""
    import copy

    from rdpn6d_tpu_torch.models.heads import DenseHead
    from rdpn6d_tpu_torch.models.quant import Int8Conv, calibrate_quant

    torch.manual_seed(0)
    head = DenseHead(48, num_filters=32, num_layers=2, skip_channels=16,
                     int8=True, int8_static=static)
    for m in head.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            with torch.no_grad():
                m.running_var.uniform_(0.2, 2.0)
                m.running_mean.normal_(0.0, 0.3)
                m.bias.normal_(0.0, 0.3)
    head = head.eval()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 48, 8, 8, generator=g)
    skip = torch.randn(3, 16, 16, 16, generator=g).clamp_min(0)
    gpu = copy.deepcopy(head).to(card, torch.bfloat16)
    if static:
        calibrate_quant(_HeadCall(gpu, skip.to(card, torch.bfloat16)).eval(),
                        [x.to(card, torch.bfloat16)])
    calls = []

    def keep(mod, args, out):
        calls.append((mod, args, out))

    hooks = [m.register_forward_hook(keep) for m in gpu.modules()
             if isinstance(m, Int8Conv)]
    before = dict(cuda_build.LAUNCHES)
    with torch.no_grad():
        gpu(x.to(card, torch.bfloat16), skip.to(card, torch.bfloat16))
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    got = {k: cuda_build.LAUNCHES.get(k, 0) - before.get(k, 0)
           for k in ("bn_relu_quantize", "quantize_act", "int8_conv")}
    assert got == {"bn_relu_quantize": 4, "quantize_act": 0,
                   "int8_conv": 4}
    assert all(args[1] is not None for _, args, _ in calls)
    with torch.no_grad():
        for mod, args, out in calls:
            cpu = copy.deepcopy(mod).cpu()
            ref = cpu(args[0].cpu(), copy.deepcopy(args[1]).cpu(),
                      None if args[2] is None else args[2].cpu())
            assert torch.equal(out.cpu(), ref)


class _HeadCall(torch.nn.Module):
    """A head with its skip bound, for ``calibrate_quant``."""

    def __init__(self, head, skip):
        super().__init__()
        self.head, self.skip = head, skip

    def forward(self, x):
        return self.head(x, self.skip)


def _crop_inputs(B, F, H, W, seed, rgb_dtype, raw, S):
    """``roi_crop``'s frame and window arguments on the CPU: noisy RGB
    (uint8 or float32), a depth surface with holes (float32 metres with a
    NaN pixel, or int32 raw units with a factor a frame), K, mixed frame
    indices, windows near the frame clamped to [1, max(H, W)]; ROI 0
    across the top-left corner, 1 wholly off the frame, 2 of scale 1, 3
    of scale max(H, W), 4 on exact half pixels."""
    g = torch.Generator().manual_seed(seed)
    rgb = torch.rand(F, H, W, 3, generator=g) * 255
    if rgb_dtype == "uint8":
        rgb = rgb.to(torch.uint8)
    depth = (0.6 + 0.4 * torch.rand(F, H, W, generator=g)) \
        * (torch.rand(F, H, W, generator=g) > 0.05)
    factor = None
    if raw:
        factor = torch.tensor([1000.0, 10000.0] * F)[:F]
        depth = torch.round(depth * factor[:, None, None]).to(torch.int32)
    else:
        depth[0, H // 2, W // 2] = float("nan")
    K = torch.tensor([[572.4 * W / 640, 0.0, W / 2],
                      [0.0, 573.6 * W / 640, H / 2], [0.0, 0.0, 1.0]]) \
        .repeat(F, 1, 1)
    frame_idx = torch.randint(0, F, (B,), generator=g)
    side = float(max(H, W))
    center = torch.rand(B, 2, generator=g) * torch.tensor([1.2 * W, 1.2 * H]) \
        - torch.tensor([0.1 * W, 0.1 * H])
    scale = ((torch.rand(B, generator=g) * 1.2 + 0.1) * side).clamp(1, side)
    edges = [((0.0, 0.0), 0.3 * side), ((-side, -side), 0.4 * side),
             ((W / 3, H / 3), 1.0), ((W / 2, H / 2), side),
             ((float(W // 2), float(H // 2)), 0.75 * S)]
    for b, ((cx, cy), sd) in enumerate(edges[:B]):
        center[b] = torch.tensor([cx, cy])
        scale[b] = sd
    return [rgb, depth, factor, K, frame_idx, center, scale]


def _same(a, b) -> bool:
    nan = a.isnan()
    return bool(torch.equal(nan, b.isnan())) and bool(
        torch.equal(a.masked_fill(nan, 0), b.masked_fill(nan, 0)))


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("B,F,rgb_dtype,raw,S,O", [
    (1, 1, "uint8", False, 256, 64), (16, 1, "uint8", False, 256, 64),
    (16, 1, "uint8", True, 256, 64), (24, 8, "uint8", True, 256, 64),
    (24, 8, "float32", False, 256, 64), (16, 8, "float32", True, 128, 32),
    (5, 2, "uint8", True, 33, 11)])
def test_roi_crop_kernel_matches_plain(card, normalize, B, F, rgb_dtype, raw,
                                       S, O):
    """Bit for bit, NaN where the plain version has NaN (the kernel rounds
    every op as the plain version does); one counted launch a call."""
    inp = [None if t is None else t.to(card) for t in
           _crop_inputs(B, F, 480, 640, B + S, rgb_dtype, raw, S)]
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    before = cuda_build.LAUNCHES.get("roi_crop", 0)
    img, coord = roi_crop(*inp, S, O, mean, std, normalize=normalize)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["roi_crop"] == before + 1
    ref_img, ref_coord = roi_crop_plain(*inp, S, O, mean, std,
                                        normalize=normalize)
    assert img.shape == (B, S, S, 6) and coord.shape == (B, O, O, 5)
    assert _same(img, ref_img) and _same(coord, ref_coord)


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("B,F,rgb_dtype,raw", [
    (24, 8, "uint8", True), (32, 8, "uint8", True), (16, 1, "uint8", False),
    (24, 8, "float32", False)])
def test_roi_crop_kernel_matches_plain_at_540x720(card, normalize, B, F,
                                                  rgb_dtype, raw):
    """T-LESS's 540x720 frames: the train and eval batches' shapes, bit for
    bit as at 480x640."""
    _crop_matches_plain(card, normalize, B, F, 540, 720, rgb_dtype, raw)


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("B,F,rgb_dtype,raw", [
    (24, 8, "uint8", True), (32, 8, "uint8", True), (24, 24, "float32",
                                                      False)])
def test_roi_crop_kernel_matches_plain_at_960x1280(card, normalize, B, F,
                                                   rgb_dtype, raw):
    """ITODD's 960x1280 frames, also as the flat path ships them (24 ROIs
    of 24 float32 frames, depth in metres), bit for bit as at 480x640."""
    _crop_matches_plain(card, normalize, B, F, 960, 1280, rgb_dtype, raw)


def _crop_matches_plain(card, normalize, B, F, H, W, rgb_dtype, raw):
    inp = [None if t is None else t.to(card) for t in
           _crop_inputs(B, F, H, W, B + 7, rgb_dtype, raw, 256)]
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    before = cuda_build.LAUNCHES.get("roi_crop", 0)
    img, coord = roi_crop(*inp, 256, 64, mean, std, normalize=normalize)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["roi_crop"] == before + 1
    ref_img, ref_coord = roi_crop_plain(*inp, 256, 64, mean, std,
                                        normalize=normalize)
    assert _same(img, ref_img) and _same(coord, ref_coord)


# The divisions by per-ROI constants at their edges, as
# tests/test_torch_roi_crop.py's DIV_EDGES: (name, depth multiplier,
# factor (None: metres), K's fx and fy, stds). Quotients below the normal
# range, z past 10^30 over an fx' near 10^-17, the factors 1 and 65535,
# stds with inexact, subnormal and NaN-sent reciprocals; each depth edge in
# both forms.
LM_STD = (58.395, 57.12, 57.375)
CROP_DIV_EDGES = [
    ("subnormal_metres", 1e-36, None, None, LM_STD),
    ("subnormal_raw", 3.0, 3e38, None, LM_STD),
    ("huge_z_tiny_fx_metres", 1e30, None, 1e-20, LM_STD),
    ("huge_z_tiny_fx_raw", 65535.0, 1e-30, 1e-20, LM_STD),
    ("factor_1", 1000.0, 1.0, None, LM_STD),
    ("factor_65535", 65535.0, 65535.0, None, LM_STD),
    ("inexact_std_metres", 1.0, None, None, (3.0, 0.1, 7e37)),
    ("tiny_std_raw", 1000.0, 1000.0, None, (1e-39, 1e-30, 255.0)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("edge", CROP_DIV_EDGES,
                         ids=[e[0] for e in CROP_DIV_EDGES])
def test_roi_crop_kernel_bit_equal_at_division_edges(card, edge, normalize):
    """The kernel's reciprocal divisions, their zero path and their IEEE
    branch give the plain version's quotients bit for bit where they
    underflow, overflow or divide by an inexact reciprocal."""
    _, mult, factor, fx, std = edge
    rgb, depth, _, K, fidx, center, scale = _crop_inputs(
        6, 2, 480, 640, 17, "uint8", False, 256)
    depth = depth.double() * mult
    if factor is not None:
        depth = torch.round(depth.nan_to_num(0)).to(torch.int32)
        factor = torch.full((2,), factor)
    else:
        depth = depth.float()
    if fx is not None:
        K[:, 0, 0] = K[:, 1, 1] = fx
    inp = [None if t is None else t.to(card)
           for t in (rgb, depth, factor, K, fidx, center, scale)]
    mean = (123.675, 116.28, 103.53)
    img, coord = roi_crop(*inp, 256, 64, mean, std, normalize=normalize)
    ref_img, ref_coord = roi_crop_plain(*inp, 256, 64, mean, std,
                                        normalize=normalize)
    torch.cuda.synchronize()
    assert _same(img, ref_img) and _same(coord, ref_coord)
    xyz = ref_img[..., 3:]
    if edge[0].startswith("subnormal"):
        assert bool(((xyz != 0) & (xyz.abs() < 2.0 ** -126)).any())
    if edge[0].startswith("huge"):
        assert bool(xyz.isinf().any())


@pytest.mark.cuda
def test_roi_crop_kernel_refuses_bad_input(card):
    inp = [None if t is None else t.to(card)
           for t in _crop_inputs(2, 1, 40, 56, 0, "uint8", True, 32)]
    mean, std = (0.0, 0.0, 0.0), (255.0, 255.0, 255.0)
    with pytest.raises(TypeError):
        roi_crop(inp[0].float().double(), *inp[1:], 32, 8, mean, std)
    with pytest.raises(ValueError):                     # mixed devices
        roi_crop(*inp[:4], inp[4].cpu(), *inp[5:], 32, 8, mean, std)
    with pytest.raises(ValueError):                     # no O grid stride
        roi_crop(*inp, 30, 8, mean, std)
    # frames past the kernel's 32-bit offsets (3 H W >= 2^31), never filled
    big = (torch.empty(1, 26755, 26755, 3, dtype=torch.uint8, device=card),
           torch.empty(1, 26755, 26755, device=card))
    with pytest.raises(ValueError, match="32-bit offsets"):
        roi_crop(*big, None, *inp[3:], 32, 8, mean, std)


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
def test_preprocessing_launches_one_roi_crop(card, train):
    """``preprocess_rois_grouped`` of 6 ROIs of 2 frames launches one
    ``roi_crop`` in eval and in train mode, and agrees with the CPU."""
    from rdpn6d_tpu_torch.config import Config
    from rdpn6d_tpu_torch.data.pipeline import preprocess_rois_grouped
    from rdpn6d_tpu_torch.data.synthetic import dummy_grouped_inputs

    cfg = Config()
    frames, rois = dummy_grouped_inputs(cfg, n_frames=2, rois_per_frame=3,
                                        seed=5, im_hw=(480, 640),
                                        focal=572.0, ship_xyz=True)
    bbox = torch.from_numpy(rois["bbox"])
    cs = (0.5 * (bbox[:, :2] + bbox[:, 2:]),
          1.5 * (bbox[:, 2:] - bbox[:, :2]).amax(-1))
    outs = []
    for dev in ("cpu", card):
        cuda_build.reset_launches()
        out = preprocess_rois_grouped(
            cfg, {k: torch.from_numpy(v).to(dev) for k, v in frames.items()},
            {k: torch.from_numpy(v).to(dev) for k, v in rois.items()},
            train=train, center_scale=tuple(t.to(dev) for t in cs))
        outs.append({k: v.cpu() for k, v in out.items()})
    assert cuda_build.LAUNCHES.get("roi_crop", 0) == 1
    cpu, gpu = outs
    # float32 on both; the card's torch.linspace and CPU's may round the
    # coordinate map's axes apart by an ulp
    for k in ("roi_img", "roi_coord_2d"):
        assert float((cpu[k] - gpu[k]).abs().max()) <= 1e-5, k


@pytest.mark.cuda
def test_roi_crop_build_spills_nothing(card):
    _, built = cuda_build.load("roi_crop")
    usage = {name: u for name, u in cuda_build.ptxas_usage(built.log).items()
             if "roi_crop_kernel" in name}
    assert len(usage) == 4
    for name, u in usage.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0, (name, u)


def _ransac_inputs(B, N, seed, dev, special=True):
    """Correspondences of a known pose per ROI (mm noise), ~10 cm outliers
    at 0/30/60%, 85% of the mask set; with ``special`` the last ROI has no
    valid point, the one before 3, the one before that a NaN point."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(B, 3, 3))
    R = q * np.sign(np.linalg.det(q))[:, None, None]
    t = np.stack([rng.uniform(-0.1, 0.1, B), rng.uniform(-0.1, 0.1, B),
                  rng.uniform(0.6, 1.2, B)], 1)
    m = rng.randn(B, N, 3) * 0.05
    c = np.einsum("bij,bnj->bni", R, m) + t[:, None] \
        + rng.randn(B, N, 3) * 0.001
    out = rng.rand(B, N) < np.array([0.0, 0.3, 0.6])[np.arange(B) % 3, None]
    c[out] += rng.randn(int(out.sum()), 3) * 0.1
    mask = (rng.rand(B, N) < 0.85).astype(np.float32)
    if special and B >= 3:
        mask[-1] = 0.0
        mask[-2] = 0.0
        mask[-2, rng.choice(N, 3, replace=False)] = 1.0
        m[-3, N // 2, 1] = np.nan
    u = rng.rand(B, 128, 4)
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
            for x in (m, c, mask, u)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(1, 4096), (8, 4096), (16, 4096),
                                 (32, 4096), (3, 100), (2, 4097), (5, 9000),
                                 (64, 4096), (200, 4096)])
def test_ransac_kabsch_kernel_matches_plain(card, B, N):
    """The kernel against its plain version on the card: the best
    hypothesis, its score and the ratio equal (the kernel's fits and d²
    are the plain version's bits), R, t within 1e-4; NaN patterns equal; a
    ROI without a valid point gets R = I from both (a zero covariance).
    The clusters on an H100 SXM: 16 blocks a ROI at B <= 7, 8 at 8, 4 at
    16, 2 at 32 and 64, 1 at 200; N = 100 leaves 15 of 16 blocks without a
    point, N = 4097 a tile of one point, N = 9000 needs two blocks at
    least."""
    from rdpn6d_tpu_torch.ops.ransac_kabsch import (
        ransac_kabsch,
        ransac_kabsch_plain,
    )

    args = _ransac_inputs(B, N, B * 7 + N, card)
    cuda_build.reset_launches()
    got = [x.cpu() for x in ransac_kabsch(*args, 0.015)]
    assert cuda_build.LAUNCHES["ransac_kabsch"] == 1
    ref = [x.cpu() for x in ransac_kabsch_plain(*args, 0.015)]
    assert torch.equal(got[0].isnan(), ref[0].isnan())
    assert torch.equal(got[1].isnan(), ref[1].isnan())
    assert torch.equal(got[3], ref[3])
    assert torch.equal(got[4], ref[4])
    assert torch.equal(got[2], ref[2])
    fin = ~ref[0].isnan().flatten(1).any(1)
    assert float((got[0][fin] - ref[0][fin]).abs().max()) <= 1e-4
    assert float((got[1][fin] - ref[1][fin]).abs().max()) <= 1e-4
    if B >= 3:
        np.testing.assert_allclose(got[0][-1].numpy(), np.eye(3), atol=1e-6)


def _ransac_bits(res):
    """A fit's outputs as integers, NaN payloads included."""
    R, t, ratio, best, score = (x.cpu() for x in res)
    return [R.view(torch.int32), t.view(torch.int32),
            ratio.view(torch.int32), best, score]


@pytest.mark.cuda
def test_ransac_kabsch_roi_does_not_depend_on_its_batch(card):
    """A ROI's outputs are bit-equal alone (a cluster of 16 blocks) and in
    batches of 8, 16, 32, 64 and 200 (on an H100 SXM clusters of 8, 4, 2,
    2 and 1), which hold every cluster size the card gives a batch of up
    to 200: the refit sums a fixed tile tree in tile order, and counts are
    integers. The last 16 ROIs hold the no-valid-point, 3-valid and NaN
    ROIs."""
    from rdpn6d_tpu_torch.ops.ransac_kabsch import (
        cluster_blocks,
        cluster_slots,
        ransac_kabsch,
    )

    m, c, mask, u = _ransac_inputs(200, 4096, 11, card)
    full = _ransac_bits(ransac_kabsch(m, c, mask, u, 0.015))
    slots = cluster_slots(torch.cuda.current_device())
    batches = (1, 8, 16, 32, 64, 200)
    sizes = [cluster_blocks(B, slots) for B in batches]
    assert sizes[0] == 16 and sizes[-1] == 1 and sizes == sorted(sizes)[::-1]
    assert {cluster_blocks(B, slots) for B in range(1, 201)} == set(sizes)
    for B in batches[1:-1]:
        part = _ransac_bits(ransac_kabsch(m[-B:], c[-B:], mask[-B:], u[-B:],
                                          0.015))
        for a, b in zip(part, full):
            assert torch.equal(a, b[-B:]), B
    for i in range(184, 200):
        one = _ransac_bits(ransac_kabsch(m[i:i + 1], c[i:i + 1],
                                         mask[i:i + 1], u[i:i + 1], 0.015))
        for a, b in zip(one, full):
            assert torch.equal(a, b[i:i + 1]), i


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 16, 200])
def test_ransac_kabsch_launches_repeat_bit_for_bit(card, B):
    """Two launches on the same inputs give the same bits: no float
    atomics, and integer counts in any order."""
    from rdpn6d_tpu_torch.ops.ransac_kabsch import ransac_kabsch

    args = _ransac_inputs(B, 4096, B, card)
    cuda_build.reset_launches()
    first = _ransac_bits(ransac_kabsch(*args, 0.015))
    second = _ransac_bits(ransac_kabsch(*args, 0.015))
    assert cuda_build.LAUNCHES["ransac_kabsch"] == 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ransac_kabsch_kernel_refuses_bad_input(card):
    from rdpn6d_tpu_torch.ops.ransac_kabsch import ransac_kabsch

    m, c, mask, u = _ransac_inputs(2, 64, 0, card, special=False)
    with pytest.raises(TypeError, match="float32"):
        ransac_kabsch(m.double(), c, mask, u)
    with pytest.raises(ValueError, match="different devices"):
        ransac_kabsch(m, c.cpu(), mask, u)
    with pytest.raises(ValueError, match="at most 16"):
        ransac_kabsch(m, c, mask, torch.rand(2, 128, 17, device=card))


@pytest.mark.cuda
def test_ransac_kabsch_build_spills_nothing(card):
    _, built = cuda_build.load("ransac_kabsch")
    usage = {name: u for name, u in cuda_build.ptxas_usage(built.log).items()
             if "ransac_kabsch_kernel" in name}
    assert len(usage) == 1
    for name, u in usage.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0, (name, u)


@pytest.mark.cuda
def test_use_pnp_launches_one_ransac_a_batch(card):
    """``Predictor`` with ``test.use_pnp`` at a tiny width on the card:
    one ``ransac_kabsch`` launch a served batch, finite poses."""
    from rdpn6d_tpu_torch.config import Config
    from rdpn6d_tpu_torch.data.assets import synthetic_class_assets
    from rdpn6d_tpu_torch.engine.predictor import Detection, Predictor

    cfg = Config().apply_opts([
        "backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16", "test.use_pnp=true"])
    pred = Predictor(cfg, synthetic_class_assets(num_regions=4),
                     batch_size=3, dtype=torch.float32, device=card,
                     allow_random_init=True)
    rng = np.random.RandomState(0)
    rgb = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    depth = (0.8 + 0.1 * rng.rand(480, 640)).astype(np.float32)
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                 np.float32)
    dets = [Detection(1, np.array([100 + 40 * i, 120, 220 + 40 * i, 260.0]))
            for i in range(5)]
    cuda_build.reset_launches()
    out = pred.predict(rgb, depth, K, dets)
    assert cuda_build.LAUNCHES["ransac_kabsch"] == 2
    assert len(out) == 5 and all(np.isfinite(r["R"]).all() for r in out)
