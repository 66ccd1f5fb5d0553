"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against
their plain versions on the card, one lm13 train step on the card, and the
entry points' default device.

They skip where there is no card. This file imports neither jax nor the
JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rdpn6d_tpu_torch.ops import cuda_build
from rdpn6d_tpu_torch.ops.gt_labels import gt_labels, gt_labels_plain
from rdpn6d_tpu_torch.ops.min_dist import min_dist2, min_dist2_plain
from rdpn6d_tpu_torch.ops.region import region_label, region_label_plain
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
    and 5 and 130 equidistant from a pixel: both kernels take the lower
    index, as the plain version does."""
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
