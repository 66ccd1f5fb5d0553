#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rdpn6d_tpu_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, serves and trains on the
card.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure:
  1. build  — every CUDA kernel of the paths, from ``rdpn6d_tpu_torch/csrc``
              with nvcc for sm_90a (in parallel, one nvcc per source);
  2. kernel — each kernel against its plain PyTorch version on the card, at
              ragged shapes and at the shape its path gives it (scoring for
              ``min_dist2``, the train step for ``gt_labels`` and
              ``region_label``, lmo's PBR step for ``surface_labels``: 24
              ROIs of 8 480x640 frames, packed masks, K = 32), with kernel,
              plain, library-call and bound times; ``min_dist2`` also with
              b split over blocks and with a NaN row, whose NaN pattern
              must equal the plain version's; the label kernels also past
              64 keypoints (65 and 200); ``surface_labels`` with every mask
              kind, both coordinate modes, crops off the frame and taps on
              exact half pixels, masks and ids equal to the plain
              version's;
  3. serve  — the lm13 configuration at full width (ResNet-34, 256² ROIs,
              64² head maps, 32 regions, rot_concat), seeded random
              weights, through ``Predictor.predict``: 3 distinct 480x640
              RGB-D frames with 5, 6 and 5 detections, in bf16 and float32;
  4. score  — ADD / ADI / re / te / proj of those poses against seeded GT
              poses on a 13-object bank of 4096 model points each; ADI
              goes through the ``min_dist2`` kernel (its launch count must
              rise) and must match the same scoring on the CPU;
  5. parity — the float32 served path on the card (no TF32) against the
              same weights and frames on the CPU;
  6. train  — the lm13 configuration at full width (as above, bf16 autocast
              over float32 weights, 24 ROIs a step, seeded init, no
              pretrained trunk) through ``Trainer.train`` for 12 steps on
              card-resident raw frames: 2 batches of 8 distinct 480x640
              RGB-D frames with 3 rendered cubes each and their per-ROI GT
              (xyz maps, packed masks), preprocessed with ``train=True`` on
              the card (masks, region ids and coordinate targets through
              the ``gt_labels`` kernel, whose launch count must rise);
              every loss finite at every step, ``grad_norm`` finite and
              > 0, weights and BatchNorm
              statistics moved; median ms/step over steps 3-12, ROIs/s and
              peak memory;
  7. train parity — one float32 step (no TF32) at lm13 full width, 4 ROIs,
              same weights and inputs, on the card and on the CPU: every
              loss and ``grad_norm`` within 1e-3 relative;
  8. labels — ``preprocess_rois_grouped(train=True)`` of 6 ROIs on the card
              and on the CPU, with GT xyz maps (``gt_labels``) and without
              (the depth surface's coordinates, ``surface_labels``); each
              kernel's launch count must rise and ``region_label``'s stay
              0, masks equal, region ids on >= 0.999 of the pixels,
              coordinates within 1e-5;
  9. eval   — ``main --eval-only`` at lm13 full width on an LM tree of 13
              objects x 8 frames written here (one ``min_dist2`` launch an
              object), f32 ``run_eval`` card vs CPU on 2 objects, host PNG
              decode times, and ``min_dist2`` at the eval shapes (8 and
              1000 ROIs x 3000 x 3000 points) beside its plain version and
              ``cdist``;
 10. train from disk — ``main`` (no ``--eval-only``) at lm13 full width, 24
              ROIs a step, bf16 autocast, Ranger, on ``lm_13_train`` (phase
              9's tree: train lists and GT xyz crops) and
              ``lm_imgn_13_train_1k_per_obj`` (an lm_imgn tree of 13
              objects x 4 frames written beside it), with the trunk loaded
              from a seeded torchvision-keyed ResNet-34 .pth named by
              ``RDPN6D_PRETRAINED_DIR``: 2 epochs (12 iterations through the
              decode pool and the device frame cache; labels through
              ``gt_labels``), a checkpoint each epoch, eval on
              ``lm_13_test`` at the end (ADI on ``min_dist2``); then
              ``main --resume`` with a 3-epoch horizon, which must start at
              the saved step. Checks every logged loss finite, the trunk
              equal to the .pth before the first step, the checkpoints,
              the launch counts (``gt_labels`` one an iteration,
              ``min_dist2`` one an evaluated object), a ``metrics.json``
              line a log period and cache hits in the second epoch; prints
              ms/step, the ms/step spent waiting on the loader (timed by
              wrapping the trainer's iterator here), decode frames/s at 1
              and at the default number of decode threads, the cache's
              hits, misses and resident MB and peak memory; with
              ``--profile`` also the same loop's ms/step on batches held in
              memory with the decode pool stopped;
 11. train lmo from disk — ``main`` on ``configs/lmo.py`` at lmo full width
              (ResNet-34, 256² ROIs, 64² maps, 32 regions, 8 classes), 24
              ROIs a step, bf16 autocast, Ranger, the trunk from phase 10's
              .pth, on an LM-O tree written here (``lmo_train``: PNG frames
              of 8 occluding cubes with GT xyz crops; ``lmo_pbr_train``:
              JPEG frames, depth in 0.1 mm, no xyz crops; ``lmo_bop_test``
              with BOP19 targets) and a background pool of JPEG and PNG
              files: the "code" colour aug at 0.8, background replacement
              at 0.5 with truncated foregrounds, TRAIN2 at 0.5 (cut from
              0.1 so PBR steps occur within 12 iterations), then eval on
              ``lmo_bop_test``. Checks every logged loss finite,
              ``gt_labels`` launched once a real-split iteration,
              ``surface_labels`` once a PBR iteration (the depth surface's
              labels) and ``region_label`` never, ``min_dist2`` once an
              evaluated object, private
              frames streamed and none resident in the device cache, the
              share of colour-augmented ROIs within 5 binomial sigmas of
              0.8, and ``color_augment`` on the card against the CPU under
              the same draws (<= 1e-3 on the 0..255 scale); prints
              ms/step, loader-wait ms/step, JPEG and PNG decode ms a
              480x640 frame, the background resize's ms, the PBR loader's
              frames/s at 1 and at the default number of decode threads,
              and peak memory;
 12. int8 serving — (a) ``int8_conv`` and ``quantize_act``
              (``csrc/int8_conv.cu``) against their plain versions on the
              card at lm13's head shapes at B = 16 (320->256 and 256->256,
              3x3 at 64²), one conv per trunk stage (3x3 at stride 1 and 2,
              a 1x1 stride-2 downsample), K = 32, N of 257 and 192, a
              ragged M and C_in of 40 and 8,
              in the dynamic, static and per-channel modes: xq, scales and
              outputs bit-equal, a NaN as the plain version has it; (b)
              lm13 at full width through ``Predictor`` in
              int8-head-static and int8-head (dynamic) beside bf16, on 16
              frames of 16 detections (256 poses, one batch of 16 a
              frame), each mode in turns, 4 passes each: poses/s, 6
              ``int8_conv`` and 6 ``quantize_act`` launches a served batch;
              one pass in int8-all with per-channel scales (every trunk
              block's convs too: 41 int8 convs a batch), each of its int8
              convs bit-equal to a CPU copy of the module on the card's
              input; float32 int8-head-static and int8-all per-channel card
              vs CPU with the card's calibrated scales carried to the CPU
              (through the flax quant tree) and each int8 conv's input too:
              every int8 conv's output bit-equal, poses within 1e-3; the
              free-running difference of int8-head-static and the
              activations quantized differently conv by conv printed;
              (c) ``main --eval-only`` with ``test.int8="head"
              test.int8_static=true`` on phase 9's tree and checkpoint:
              launches (6 ``int8_conv`` a batch, ``min_dist2`` one an
              object), calibration on the first batch, the MEAN table
              beside phase 9's bf16 one (reported: seeded weights), split
              wall time; (d) ``int8_conv``'s time at the head shapes by CUDA
              events, ``queued_ms`` and the profiler, beside its bound, the
              plain version, cuDNN's bf16 ``F.conv2d`` and
              ``torch._int_mm`` over ``F.unfold`` (checked equal to the
              kernel's output), and ``quantize_act``'s beside its bound;
              the conv kernel's registers, spills and shared memory from
              the build log, and its launch plan at the head.
Kernel launch counts are zeroed right before each path (phases 3-4, phase
6, each run of phase 8, phase 9's ``main``, each of phase 10's and phase
11's ``main``, each int8 served pass and the int8 ``main`` of phase 12)
and read right after it.
Output: the card's name and power limit (nvidia-smi), one
``{"kernels": [...]}`` JSON line, then ``{"ok": true, "device": {...}}`` as
the last line. Exits non-zero, printing no result, without a CUDA device or
without the ``rdpn6d_tpu_torch`` package beside this file.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s HBM3; 67 TFLOP/s FP32
# outside the tensor cores, which counts each lane's FMA as 2 operations:
# 132 SMs x 128 lanes x 1.98 GHz issue 33.5e12 FP32 instructions a second
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
# min_dist2's work per (a, b) pair: 3 subtractions, 3 multiply(-add)s and a
# min, 7 FP32 instructions
MIN_DIST2_INSTR_PER_PAIR = 7
# region_label: per (pixel, keypoint) 3 subtractions, 3 multiplies, 2 adds
# and a compare, counted as ~7 FP32 instructions (a compare and a select
# pair up); per pixel 12 B of xyz in, 4 B of region and 12 B of coord out
REGION_LABEL_INSTR_PER_PAIR = 7
REGION_LABEL_BYTES_PER_PIXEL = 28
# surface_labels: per output pixel 4 B of depth and 1 B of packed masks in,
# 4 B of m, 4 of trunc, 4 of region and 12 of coord out
SURFACE_LABELS_BYTES_PER_PIXEL = 29
GT_LABELS_OUT_RES = 64       # lm13's label maps
TRAIN_STEPS = 12
TRAIN_ROIS = 24
EVAL_FRAMES_PER_OBJ = 8      # 104 ROIs: 4 batches of 32, 2 past warm-up
EVAL_SPLIT_ROIS = 1000       # LM-13's test split: ~1k instances an object
IMGN_FRAMES_PER_OBJ = 4      # 52 lm_imgn frames: 156 train records with
ITERS_PER_EPOCH = 13 * (EVAL_FRAMES_PER_OBJ + IMGN_FRAMES_PER_OBJ) \
    // TRAIN_ROIS            # phase 9's 104, 6 iterations an epoch
TRAIN_EPOCHS = 2
RESUME_EPOCHS = 3
DECODE_BATCHES = 4           # 96 frames of the first epoch, decode timing
LMO_TRAIN_FRAMES = 12        # x 8 occluding cubes: ~96 lmo_train records,
LMO_EPOCHS = 3               # 4 iterations an epoch, 12 in all
LMO_PBR_FRAMES = 6           # one train_pbr scene: 48 records, 2 batches
LMO_TEST_FRAMES = 4          # 32 BOP19 targets, every object 4 times
LMO_TRAIN2_RATIO = 0.5       # cut from lmo's 0.1: PBR steps within 12
COLOR_AUG_TOL = 1e-3         # card vs CPU on the 0..255 scale


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``iters``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int, filler: int = 2048) -> float:
    """Device time of one call of ``fn`` in ms, the host's cost hidden: each
    call is queued behind a float32 ``filler``² matrix product (17 GFLOP at
    2048, longer on the card than the host takes to launch a call of one
    kernel; a call of many kernels needs a larger one), so its kernels run
    back to back between two CUDA events. The median over ``iters``
    calls. For calls whose device work is shorter than their host cost,
    where ``cuda_ms`` would time the host."""
    import torch

    x = torch.randn(filler, filler, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        x @ x
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def min_dist2_bound(B: int, N: int, M: int) -> tuple[float, str]:
    """Least ms the card could take for ``min_dist2`` of [B,N,3] x [B,M,3]
    (its operations, or each input read once and the output written once,
    the larger), and which of the two it is."""
    ops_s = B * N * M * MIN_DIST2_INSTR_PER_PAIR / FP32_INSTR_PER_S
    bytes_s = (B * N * 3 + B * M * 3 + B * N) * 4 / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), \
        "operations" if ops_s >= bytes_s else "bytes"


def min_dist2_plan(a, b) -> str:
    """The kernel's grid for a call on a, b, as a few words."""
    import torch

    from rdpn6d_tpu_torch.ops.min_dist import launch_plan

    B, N, D = a.shape
    p = launch_plan(B, N, b.shape[1], D, torch.cuda.get_device_properties(
        a.device).multi_processor_count)
    return f"{p.blocks} blocks, {p.splits} split(s) of b"


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of ``fn`` in ms per call: the kernels' own time summed
    over ``iters`` calls under torch.profiler. For work too small to keep
    the card busy against the host's launch rate, where CUDA events would
    time the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")
                and not getattr(e, "is_user_annotation", False))
    check(total > 0, "the profiler saw no device time")
    return total / 1e3 / iters


def lm_assets(num_regions: int, n_points: int, seed: int):
    """13 box-shaped objects with LineMOD-like extents: n_points sampled
    uniformly on each surface, FPS keypoints, no symmetries."""
    from rdpn6d_tpu_torch.data.assets import (
        ClassAssets,
        fps_numpy,
        pad_sym_trans,
        pad_symmetries,
    )

    rng = np.random.RandomState(seed)
    ext = rng.uniform(0.06, 0.2, (13, 3)).astype(np.float32)
    pts = []
    for e in ext:
        p = rng.uniform(-0.5, 0.5, (n_points, 3))
        face = rng.randint(0, 3, n_points)
        p[np.arange(n_points), face] = np.sign(
            p[np.arange(n_points), face]) * 0.5   # onto a face
        pts.append((p * e).astype(np.float32))
    pts = np.stack(pts)
    fps = np.stack([p[fps_numpy(p, num_regions)] for p in pts])
    return ClassAssets(
        obj_ids=list(range(1, 14)), points=pts, extents=ext,
        fps_points=fps, sym_rots=pad_symmetries([None] * 13),
        sym_trans=pad_sym_trans([None] * 13),
        diameters=np.linalg.norm(ext, axis=1).astype(np.float32))


def make_frames(seed: int, counts=(5, 6, 5)):
    """Distinct 480x640 RGB-D frames (smooth colour field + noise, depth
    0.6-1.2 m) with seeded detection boxes."""
    from rdpn6d_tpu_torch.engine.predictor import Detection

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    frames = []
    for f, n in enumerate(counts):
        phase = rng.uniform(0, 6.28, 3)
        rgb = np.stack([127 + 100 * np.sin(xx / (40 + 9 * c) + yy / 55
                                           + phase[c]) for c in range(3)],
                       -1) + rng.normal(0, 8, (480, 640, 3))
        depth = 0.9 + 0.3 * np.sin(xx / 120 + phase[0]) * np.cos(yy / 90)
        dets = []
        for _ in range(n):
            w, h = rng.uniform(50, 180, 2)
            x1, y1 = rng.uniform(0, 640 - w), rng.uniform(0, 480 - h)
            dets.append(Detection(int(rng.randint(1, 14)),
                                  np.array([x1, y1, x1 + w, y1 + h],
                                           np.float32),
                                  float(rng.uniform(0.5, 1.0))))
        frames.append((np.clip(rgb, 0, 255).astype(np.uint8),
                       depth.astype(np.float32), dets))
    return frames


K_LM = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
                 [0.0, 0.0, 1.0]], np.float32)


def physical_z(pred):
    """Random weights put objects millimetres from the camera; a z bias
    moves them to ~0.5-1 m, where poses project and score sensibly."""
    import torch

    with torch.no_grad():
        pred.model.pnp_net.fc_t.bias[2] = 2.0
    return pred


def profile_pass(label: str, run, rows: int = 15) -> None:
    """Device time by kernel over one pass of ``run()`` (torch.profiler),
    against the wall time of that pass (synchronized), with the number of
    kernel launches; the ``rows`` largest kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    # kernels only: an aten op's own row repeats its kernels' device time,
    # and a user annotation (Optimizer.step) spans kernels counted already
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e3   # ms
    print(f"profile: {label}: wall {secs * 1e3:.1f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / (secs * 1e3):.1f}%), "
          f"{sum(e.count for e in events)} kernel launches of "
          f"{len(events)} kernel names")
    for e in events[:rows]:
        print(f"profile: {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")


def serve(pred, frames):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [pred.predict(rgb, depth, K_LM, dets)
            for rgb, depth, dets in frames]
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def label_inputs(B, H, W, K, seed, dev):
    """Object-frame xyz maps (30% background zeros) within a 12 cm cube,
    FPS-like keypoints, GT rotations and extents, on the card."""
    import torch

    g = torch.Generator().manual_seed(seed)
    xyz = (torch.rand(B, H, W, 3, generator=g) - 0.5) * 0.12
    xyz[torch.rand(B, H, W, generator=g) < 0.3] = 0.0
    fps = (torch.rand(B, K, 3, generator=g) - 0.5) * 0.1
    q, _ = torch.linalg.qr(torch.randn(B, 3, 3, generator=g))
    rot = q * torch.linalg.det(q).sign()[:, None, None]
    ext = torch.rand(B, 3, generator=g) * 0.15 + 0.05
    return [t.contiguous().to(dev) for t in (xyz, fps, rot, ext)]


def library_region_label(xyz, fps, rot, ext):
    """The yardstick: one library distance call (``torch.cdist``) and its
    argmin, the gather and the rotation, for the same outputs as the
    ``region_label`` kernel. Timed only; the port never calls it."""
    import torch

    B, H, W, _ = xyz.shape
    x = xyz.reshape(B, H * W, 3)
    nearest = torch.cdist(x, fps).argmin(-1)
    f = torch.gather(fps, 1, nearest[..., None].expand(B, H * W, 3))
    coord = torch.einsum("bij,bnj->bni", rot, x - f) / ext[:, None] + 0.5
    region = torch.where((x != 0).any(-1), nearest + 1, 0)
    return region.reshape(B, H, W), coord.reshape(B, H, W, 3)


def near_ties(xyz, fps):
    """Pixels whose two nearest keypoints' squared distances lie within
    1e-6 of their size (float64 decides which pixels those are): there a
    region id may differ between two float32 roundings."""
    import torch

    if fps.shape[1] < 2:
        return torch.zeros(xyz.shape[:-1], dtype=torch.bool,
                           device=xyz.device)
    d2 = ((xyz.double()[..., None, :] - fps.double()[:, None, None])
          ** 2).sum(-1).sort(-1).values
    return (d2[..., 1] - d2[..., 0]) <= 1e-6 * d2[..., 1]


def check_region_label(dev, card):
    """Phase 2 for ``region_label``: the kernel against its plain version
    at ragged shapes and the train shape; returns (max coord error,
    times at the train shape)."""
    import torch

    from rdpn6d_tpu_torch.ops.region import region_label, region_label_plain

    worst = 0.0
    # keypoints in one, two and four of the kernel's 64-keypoint tiles;
    # the train shape last, timed below
    for (B, H, W, K) in [(1, 7, 5, 3), (3, 33, 31, 17), (2, 64, 64, 64),
                         (2, 33, 31, 65), (2, 17, 19, 200),
                         (TRAIN_ROIS, 64, 64, 32)]:
        xyz, fps, rot, ext = label_inputs(B, H, W, K, H + K, dev)
        reg, coord = region_label(xyz, fps, rot, ext)
        ref_reg, ref_coord = region_label_plain(xyz, fps, rot, ext)
        torch.cuda.synchronize()
        tie = near_ties(xyz, fps)
        differ = reg != ref_reg
        check(not bool((differ & ~tie).any()),
              f"region_label ids disagree away from ties at {B}x{H}x{W}x{K}")
        same = ~differ
        err = float((coord - ref_coord).abs()[same].max())
        # float32 products of ~0.1 m residuals over ~0.1 m extents, summed
        # in another order: a few ulps of values ~1
        check(err <= 1e-5, f"region_label coords differ by {err:.3e} at "
              f"{B}x{H}x{W}x{K}")
        worst = max(worst, err)
        print(f"kernel: region_label B={B} H={H} W={W} K={K} ids differ at "
              f"{int(differ.sum())} px ({int(tie.sum())} near-ties), coord "
              f"max_abs_err {err:.3e} (tol 1e-5)")
    # a few microseconds of device work a call: CUDA events around a burst
    # would time the Python wrapper, so the profiler's device time is taken
    call_ms = cuda_ms(lambda: region_label(xyz, fps, rot, ext), iters=200)
    ms = device_ms(lambda: region_label(xyz, fps, rot, ext), iters=200)
    plain_ms = device_ms(lambda: region_label_plain(xyz, fps, rot, ext),
                         iters=20)
    lib_ms = device_ms(lambda: library_region_label(xyz, fps, rot, ext),
                       iters=20)
    pixels = B * H * W
    ops_s = pixels * K * REGION_LABEL_INSTR_PER_PAIR / FP32_INSTR_PER_S
    bytes_s = (pixels * REGION_LABEL_BYTES_PER_PIXEL
               + B * (K * 3 + 9 + 3) * 4) / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(ops_s, bytes_s)
    bound_by = "operations" if ops_s >= bytes_s else "bytes"
    print(f"kernel: region_label {B}x{H}x{W} K={K} device time: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, cdist {lib_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); a wrapper call "
          f"{call_ms:.4f} ms by CUDA events [{card}]")
    return worst, dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by)


def gt_label_inputs(B, h, w, K, seed, dev, masks, half):
    """Per-ROI GT maps as the train path ships them: an elliptic object
    (xyz != 0 inside), a visib mask that spills past it, a trunc mask that
    differs; ``masks`` "packed" (uint8 bits), "trunc" (float32 visib and
    trunc) or "visib_only"; xyz in float16 when ``half``. Crop centres
    anywhere on the map and sides 0.3-1.3x its size, so crops run off its
    edges. Returns ``gt_labels``' arguments before out_res, on the card."""
    import torch

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
        mask = visib.to(torch.uint8) | (trunc.to(torch.uint8) << 1)
        trunc = None
    else:
        mask = visib.float()
        trunc = trunc.float() if masks == "trunc" else None
    center = torch.rand(B, 2, generator=g) * torch.tensor([w, h])
    scale = (torch.rand(B, generator=g) + 0.3) * max(h, w)
    _, fps, rot, ext = label_inputs(B, 1, 1, K, seed, "cpu")
    return [None if t is None else t.contiguous().to(dev) for t in
            (mask, trunc, xyz.half() if half else xyz, center, scale, fps,
             rot, ext)]


def library_gt_labels(mask, trunc, xyz, center, scale, fps, rot, ext, o):
    """The yardstick for packed masks: an advanced-index gather of the
    shipped maps at the rounded taps, then one library distance call
    (``torch.cdist``), its argmin, the gather and the rotation. Timed
    only; the port never calls it."""
    import torch

    B, h, w = mask.shape
    grid = torch.arange(o, dtype=torch.float32, device=mask.device) - o / 2
    r = scale[:, None] / o
    ix = torch.round(center[:, 0:1] + grid * r).long()
    iy = torch.round(center[:, 1:2] + grid * r).long()
    valid = ((ix >= 0) & (ix < w))[:, None, :] \
        & ((iy >= 0) & (iy < h))[:, :, None]
    b = torch.arange(B, device=mask.device)[:, None, None]
    yi, xi = iy.clamp(0, h - 1)[:, :, None], ix.clamp(0, w - 1)[:, None, :]
    x = xyz[b, yi, xi].float() * valid[..., None]
    bits = mask[b, yi, xi]
    obj = (x != 0).any(-1)
    flat = x.reshape(B, o * o, 3)
    nearest = torch.cdist(flat, fps).argmin(-1)
    f = torch.gather(fps, 1, nearest[..., None].expand(B, o * o, 3))
    coord = torch.einsum("bij,bnj->bni", rot, flat - f) / ext[:, None] + 0.5
    region = torch.where(obj.reshape(B, -1), nearest + 1, 0)
    return (((bits & 1) > 0) & obj).float(), obj.float(), \
        ((bits & 2) > 0).logical_and(obj).float(), \
        region.reshape(B, o, o), coord.reshape(B, o, o, 3)


def check_gt_labels(dev, card):
    """Phase 2 for ``gt_labels``: the kernel against its plain version at
    ragged shapes and the train shape (24 ROIs of 480x640 maps -> 64², K =
    32), for both mask kinds, both xyz types and both coordinate modes;
    returns (max coord error, times at the train shape with packed masks
    and float16 xyz, the path's inputs)."""
    import torch

    from rdpn6d_tpu_torch.ops.gt_labels import gt_labels, gt_labels_plain
    from rdpn6d_tpu_torch.ops.warp import crop_resize_frames

    worst = 0.0
    for (B, h, w, o, K) in [(1, 7, 5, 3, 3), (3, 33, 31, 17, 17),
                            (2, 100, 90, 33, 64), (3, 50, 60, 17, 65),
                            (2, 60, 70, 13, 200),
                            (TRAIN_ROIS, 480, 640, GT_LABELS_OUT_RES, 32)]:
        for masks, half in (("packed", True), ("packed", False),
                            ("trunc", False), ("visib_only", True)):
            inp = gt_label_inputs(B, h, w, K, h + K, dev, masks, half)
            if B == 2:    # every other source coordinate exactly on .5
                inp[3] = inp[3].round()
                inp[4] = torch.full_like(inp[4], o / 2)
            xyz_c = crop_resize_frames(inp[2].float(),
                                       torch.arange(B, device=dev), inp[3],
                                       inp[4], o, interp="nearest")
            tie = near_ties(xyz_c, inp[5])
            n_differ, case_err = 0, 0.0
            for residual in (True, False):
                got = gt_labels(*inp, o, residual=residual)
                ref = gt_labels_plain(*inp, o, residual=residual)
                torch.cuda.synchronize()
                for k in ("roi_mask_visib", "roi_mask_obj", "roi_mask_trunc"):
                    check(torch.equal(got[k], ref[k]), f"gt_labels {k} "
                          f"differs at {B}x{h}x{w}->{o} K={K} {masks}")
                differ = got["roi_region"] != ref["roi_region"]
                check(not bool((differ & ~tie).any()), "gt_labels ids "
                      f"disagree away from ties at {B}x{h}x{w}->{o} K={K}")
                same = ~differ
                err = float((got["roi_xyz"] - ref["roi_xyz"]).abs()[same]
                            .max())
                check(err <= 1e-5, f"gt_labels coords differ by {err:.3e} "
                      f"at {B}x{h}x{w}->{o} K={K} {masks}")
                case_err = max(case_err, err)
                n_differ += int(differ.sum())
            worst = max(worst, case_err)
            print(f"kernel: gt_labels B={B} {h}x{w}->{o} K={K} {masks} "
                  f"xyz {'float16' if half else 'float32'}: masks equal, ids "
                  f"differ at {n_differ} px over both modes "
                  f"({int(tie.sum())} near-ties), coord max_abs_err "
                  f"{case_err:.3e} (tol 1e-5)")
    inp = gt_label_inputs(TRAIN_ROIS, 480, 640, 32, 0, dev, "packed", True)
    o, B, K = GT_LABELS_OUT_RES, TRAIN_ROIS, 32
    ms = device_ms(lambda: gt_labels(*inp, o), iters=200)
    plain_ms = device_ms(lambda: gt_labels_plain(*inp, o), iters=20)
    lib_ms = device_ms(lambda: library_gt_labels(*inp, o), iters=20)
    pixels = B * o * o
    # the distance work of region_label; per output pixel its tap of the
    # packed masks (1 B) and float16 xyz (6 B) in, 3 float32 masks, region
    # and coord out
    ops_s = pixels * K * REGION_LABEL_INSTR_PER_PAIR / FP32_INSTR_PER_S
    bytes_s = (pixels * (1 + 6 + 3 * 4 + 4 + 12)
               + B * (K * 3 + 9 + 3 + 2 + 1) * 4) / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(ops_s, bytes_s)
    bound_by = "operations" if ops_s >= bytes_s else "bytes"
    print(f"kernel: gt_labels {B}x480x640->{o} K={K} packed masks, float16 "
          f"xyz, device time: kernel {ms:.5f} ms, plain {plain_ms:.4f} ms, "
          f"gather+cdist {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}) [{card}]")
    return worst, dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by)


def surface_label_inputs(B, F, h, w, K, seed, dev, masks):
    """The depth-surface branch's inputs as the PBR split ships them: F
    depth frames (a ~0.7 m surface with 5% holes), each ROI's frame and
    full-frame masks (``masks`` as ``gt_label_inputs``), its K (LineMOD's
    focal scaled to the frame), a crop anywhere on the frame with a side
    0.3-1.3x its size, a GT pose whose origin sits on the surface at the
    crop's centre, keypoints, R and extents. Returns ``surface_labels``'
    arguments before out_res, on the card."""
    import torch

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
        mask = visib.to(torch.uint8) | (trunc.to(torch.uint8) << 1)
        trunc = None
    else:
        mask = visib.float()
        trunc = trunc.float() if masks == "trunc" else None
    f = float(K_LM[0, 0]) * max(h, w) / 640
    cam = torch.tensor([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]]) \
        .repeat(B, 1, 1)
    cam[:, :2, 2] += torch.rand(B, 2, generator=g) - 0.5
    center = torch.rand(B, 2, generator=g) * torch.tensor([w, h])
    scale = (torch.rand(B, generator=g) + 0.3) * max(h, w)
    trans = torch.stack([(center[:, 0] - cam[:, 0, 2]) * 0.7 / f,
                         (center[:, 1] - cam[:, 1, 2]) * 0.7 / f,
                         torch.full((B,), 0.7)], -1)
    _, fps, rot, ext = label_inputs(B, 1, 1, K, seed, "cpu")
    return [None if t is None else t.contiguous().to(dev) for t in
            (depth, frame_idx, mask, trunc, cam, center, scale, fps, rot,
             trans, ext)]


def library_surface_labels(depth, frame_idx, mask, trunc, cam, center,
                           scale, fps, rot, trans, ext, o):
    """The yardstick for packed masks: an advanced-index gather of the
    depth and the masks at the rounded taps, the back-projection and the
    rotation (an einsum), then one library distance call
    (``torch.cdist``), its argmin, the gather and the rotation. Timed
    only; the port never calls it."""
    import torch

    B, h, w = mask.shape
    grid = torch.arange(o, dtype=torch.float32, device=mask.device) - o / 2
    r = scale[:, None] / o
    ix = torch.round(center[:, 0:1] + grid * r).long()
    iy = torch.round(center[:, 1:2] + grid * r).long()
    valid = ((ix >= 0) & (ix < w))[:, None, :] \
        & ((iy >= 0) & (iy < h))[:, :, None]
    b = torch.arange(B, device=mask.device)[:, None, None]
    yi, xi = iy.clamp(0, h - 1)[:, :, None], ix.clamp(0, w - 1)[:, None, :]
    d = depth[frame_idx[:, None, None], yi, xi] * valid
    bits = mask[b, yi, xi]
    m = ((bits & 1) > 0) & (d > 1e-6)
    c = cam[:, None, None]
    p = torch.stack([(xi - c[..., 0, 2]) * d / c[..., 0, 0],
                     (yi - c[..., 1, 2]) * d / c[..., 1, 1], d], -1)
    xyz = torch.einsum("bhwj,bjk->bhwk", p - trans[:, None, None], rot) \
        * m[..., None]
    flat = xyz.reshape(B, o * o, 3)
    nearest = torch.cdist(flat, fps).argmin(-1)
    f = torch.gather(fps, 1, nearest[..., None].expand(B, o * o, 3))
    coord = torch.einsum("bij,bnj->bni", rot, flat - f) / ext[:, None] + 0.5
    region = torch.where((flat != 0).any(-1), nearest + 1, 0)
    return m.float(), (((bits & 2) > 0) & m).float(), \
        region.reshape(B, o, o), coord.reshape(B, o, o, 3)


def check_surface_labels(dev, card):
    """Phase 2 for ``surface_labels``: the kernel against its plain version
    at ragged shapes and lmo's PBR step (24 ROIs of 8 480x640 frames ->
    64², K = 32), for every mask kind and both coordinate modes; masks and
    ids must equal the plain version's, coordinates within 1e-6 (the
    kernel rounds every op as the plain version does, so 0 is expected).
    Returns (max coord error, times at lmo's shape with packed masks)."""
    import torch

    from rdpn6d_tpu_torch.ops.surface_labels import (
        surface_labels,
        surface_labels_plain,
    )

    worst = 0.0
    for (B, F, h, w, o, K) in [(1, 1, 7, 5, 3, 1), (3, 2, 33, 31, 17, 32),
                               (2, 1, 100, 90, 33, 65),
                               (2, 2, 60, 70, 13, 200),
                               (TRAIN_ROIS, 8, 480, 640, GT_LABELS_OUT_RES,
                                32)]:
        for masks in ("packed", "trunc", "visib_only"):
            inp = surface_label_inputs(B, F, h, w, K, h + K, dev, masks)
            if B == 2:    # every other source coordinate exactly on .5
                inp[5] = inp[5].round()
                inp[6] = torch.full_like(inp[6], o / 2)
            case_err, fg = 0.0, 0.0
            for residual in (True, False):
                got = surface_labels(*inp, o, residual=residual)
                ref = surface_labels_plain(*inp, o, residual=residual)
                torch.cuda.synchronize()
                for k in ("roi_mask_visib", "roi_mask_obj", "roi_mask_trunc"):
                    check(torch.equal(got[k], ref[k]), f"surface_labels {k} "
                          f"differs at {B}x{h}x{w}->{o} K={K} {masks}")
                check(torch.equal(got["roi_region"], ref["roi_region"]),
                      f"surface_labels ids differ at {B}x{h}x{w}->{o} K={K} "
                      f"{masks}")
                err = float((got["roi_xyz"] - ref["roi_xyz"]).abs().max())
                check(err <= 1e-6, f"surface_labels coords differ by "
                      f"{err:.3e} at {B}x{h}x{w}->{o} K={K} {masks}")
                case_err = max(case_err, err)
                fg = float(ref["roi_mask_obj"].mean())
            worst = max(worst, case_err)
            print(f"kernel: surface_labels B={B} F={F} {h}x{w}->{o} K={K} "
                  f"{masks}: masks and ids equal in both modes, coord "
                  f"max_abs_err {case_err:.3e} (tol 1e-6), object share "
                  f"{fg:.3f}")
    B, F, o, K = TRAIN_ROIS, 8, GT_LABELS_OUT_RES, 32
    inp = surface_label_inputs(B, F, 480, 640, K, 0, dev, "packed")
    ms = device_ms(lambda: surface_labels(*inp, o), iters=200)
    q_ms = queued_ms(lambda: surface_labels(*inp, o), iters=200)
    plain_ms = device_ms(lambda: surface_labels_plain(*inp, o), iters=20)
    lib_ms = device_ms(lambda: library_surface_labels(*inp, o), iters=20)
    pixels = B * o * o
    # the distance work of region_label; per output pixel the taps of the
    # depth and the packed masks in, m, trunc, region and coord out; per ROI
    # its scalars and keypoints
    ops_s = pixels * K * REGION_LABEL_INSTR_PER_PAIR / FP32_INSTR_PER_S
    bytes_s = (pixels * SURFACE_LABELS_BYTES_PER_PIXEL
               + B * ((K * 3 + 9 + 9 + 3 + 3 + 2 + 1) * 4 + 8)) \
        / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(ops_s, bytes_s)
    bound_by = "operations" if ops_s >= bytes_s else "bytes"
    print(f"kernel: surface_labels {B} ROIs of {F} 480x640 frames ->{o} "
          f"K={K} packed masks, device time: kernel {ms:.5f} ms (queued "
          f"{q_ms:.5f} ms), plain {plain_ms:.4f} ms, gather+cdist "
          f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
    return worst, dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by)


def train_config(amp: bool, out_dir: str):
    """lm13 at full width, seeded fan-in init, no pretrained trunk (the
    torchvision weights are not on disk), 24 ROIs a step; the trainer's
    metrics and checkpoint (at its last step only) under ``out_dir``."""
    from rdpn6d_tpu_torch.configs import lm13

    return lm13.get_config().apply_opts([
        'head.init="fan_in"', 'backbone.pretrained=""',
        f"solver.ims_per_batch={TRAIN_ROIS}", f"solver.amp={str(amp).lower()}",
        "train.log_period=1", "train.checkpoint_period_epochs=1e9",
        f'train.output_dir="{out_dir}"'])


def train_inputs(cfg, seed, n_frames, rois_per_frame, ship_xyz=True):
    """Raw grouped train inputs: distinct 480x640 frames of rendered cubes
    with LineMOD's focal length, packed masks and (``ship_xyz``) per-ROI
    xyz maps."""
    from rdpn6d_tpu_torch.data.synthetic import dummy_grouped_inputs

    frames, rois = dummy_grouped_inputs(
        cfg, n_frames=n_frames, rois_per_frame=rois_per_frame, seed=seed,
        im_hw=(480, 640), ship_xyz=ship_xyz, focal=float(K_LM[0, 0]))
    n = n_frames * rois_per_frame
    rois["roi_cls"] = (np.arange(n) % cfg.head.num_classes).astype(np.int32)
    return frames, rois


def run_train(dev, card, profile: bool, work: str):
    """Phase 6: ``Trainer.train`` at lm13 full width on the card; with
    ``profile``, one more step (preprocessing included) under the
    profiler after the launch counts are read."""
    import torch

    from rdpn6d_tpu_torch.data.pipeline import preprocess_rois_grouped
    from rdpn6d_tpu_torch.engine.trainer import Trainer
    from rdpn6d_tpu_torch.models import RDPN, init_weights
    from rdpn6d_tpu_torch.ops import cuda_build

    cfg = train_config(amp=True, out_dir=os.path.join(work, "phase6"))
    t0 = time.perf_counter()
    batches = []
    for s in range(2):
        frames, rois = train_inputs(cfg, 10 + s, 8, TRAIN_ROIS // 8)
        batches.append({
            "frames": {k: torch.from_numpy(v).to(dev)
                       for k, v in frames.items()},
            "rois": {k: torch.from_numpy(v).to(dev)
                     for k, v in rois.items()}})
    print(f"train: rendered 2 batches of {TRAIN_ROIS} ROIs in "
          f"{time.perf_counter() - t0:.1f} s (host, set-up)")
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(0))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainer = Trainer(cfg, model, total_iters=TRAIN_STEPS, device=dev)
    stamps, hist = [], []

    def hook(it, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        hist.append({k: float(v) for k, v in metrics.items()})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    start = time.perf_counter()
    trainer.train(itertools.cycle(batches), step_hook=hook)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    check(len(hist) == TRAIN_STEPS, f"train ran {len(hist)} steps")
    for i, m in enumerate(hist):
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        check(not bad, f"train step {i + 1}: non-finite {bad}")
        check(m["grad_norm"] > 0, f"train step {i + 1}: zero gradient")
    check(launches.get("gt_labels", 0) >= TRAIN_STEPS,
          f"gt_labels launched {launches.get('gt_labels', 0)} times "
          f"in {TRAIN_STEPS} train steps")
    after = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    params = [n for n, _ in model.named_parameters()]
    moved = sum(not torch.equal(after[n], before[n]) for n in params)
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    moved_stats = sum(not torch.equal(after[k], before[k]) for k in stats)
    check(moved > 0.5 * len(params), f"only {moved}/{len(params)} "
          "parameter tensors moved")
    check(moved_stats == len(stats), f"only {moved_stats}/{len(stats)} "
          "BatchNorm statistics moved")
    step_ms = 1e3 * np.diff([start] + stamps)
    med = float(np.median(step_ms[2:TRAIN_STEPS]))
    for i, m in enumerate(hist):
        print(f"train: step {i + 1:2d} {step_ms[i]:8.2f} ms  total_loss "
              f"{m['total_loss']:.4f}  grad_norm {m['grad_norm']:.4f}")
    print(f"train: lm13 full width bf16 autocast, {TRAIN_ROIS} ROIs/step: "
          f"median {med:.2f} ms/step over steps 3-{TRAIN_STEPS} = "
          f"{TRAIN_ROIS / med * 1e3:.1f} ROIs/s, peak memory "
          f"{peak / 2**30:.2f} GiB, {moved}/{len(params)} weights and "
          f"{moved_stats}/{len(stats)} BN statistics moved; launches "
          f"{launches} [{card}]")
    if profile:
        def one_step():
            b = batches[0]
            batch = preprocess_rois_grouped(
                cfg, b["frames"], b["rois"], train=True,
                generator=trainer.generator)
            trainer.state, m = trainer.step_fn(trainer.state, batch)
            float(m["total_loss"])

        profile_pass("train step, bf16 autocast", one_step)
    return launches


def train_parity(dev, work):
    """Phase 7: one float32 step on the card and on the CPU from the same
    weights and the same (CPU-preprocessed) batch. Every loss within 1e-3
    relative. ``grad_norm`` within 1e-3 relative or twice what the CPU's
    own ``grad_norm`` moves when the input moves by 1e-6 relative, the
    larger: at this seeded init the gradient is ill-conditioned (BatchNorm
    on batch statistics of 4 ROIs), and a float32 reordering is a
    perturbation of that size."""
    import torch

    from rdpn6d_tpu_torch.data.pipeline import preprocess_rois_grouped
    from rdpn6d_tpu_torch.models import RDPN, init_weights
    from rdpn6d_tpu_torch.parallel import create_train_state, make_train_step
    from rdpn6d_tpu_torch.solver import build_schedule

    cfg = train_config(amp=False, out_dir=os.path.join(work, "phase7"))
    frames, rois = train_inputs(cfg, 30, 2, 2)
    batch = preprocess_rois_grouped(
        cfg, {k: torch.from_numpy(v) for k, v in frames.items()},
        {k: torch.from_numpy(v) for k, v in rois.items()}, train=True,
        generator=torch.Generator().manual_seed(0))
    schedule = build_schedule(cfg, 1000)
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(1))
    cpu = torch.device("cpu")
    out = {}
    for name, d, scale in (("card", dev, 1.0), ("cpu", cpu, 1.0),
                           ("cpu_moved", cpu, 1.0 + 1e-6)):
        m = copy.deepcopy(model).to(d)
        state = create_train_state(cfg, m, lr=schedule(0))
        b = {k: v.to(d) for k, v in batch.items()}
        b["roi_img"] = b["roi_img"] * scale
        _, metrics = make_train_step(cfg, schedule)(state, b)
        out[name] = {k: float(v) for k, v in metrics.items()}

    def rel(a, k):
        ref = out["cpu"][k]
        return abs(out[a][k] - ref) / max(abs(ref), 1e-6)

    sens = rel("cpu_moved", "grad_norm")
    gn_tol = max(1e-3, 2 * sens)
    worst = 0.0
    for k in out["cpu"]:
        # float32 both sides, TF32 off; cuDNN and oneDNN sum in other
        # orders through ~40 layers and their backward passes
        tol = gn_tol if k == "grad_norm" else 1e-3
        check(rel("card", k) <= tol, f"train parity: {k} card "
              f"{out['card'][k]:.6g} vs CPU {out['cpu'][k]:.6g} (tol {tol})")
        if k != "grad_norm":
            worst = max(worst, rel("card", k))
    print(f"train parity: f32 step, 4 ROIs, card vs CPU: total_loss "
          f"{out['card']['total_loss']:.6f} vs {out['cpu']['total_loss']:.6f}"
          f"; max relative difference over {len(out['cpu']) - 1} losses "
          f"{worst:.3e} (tol 1e-3); grad_norm {out['card']['grad_norm']:.6f}"
          f" vs {out['cpu']['grad_norm']:.6f}, relative "
          f"{rel('card', 'grad_norm'):.3e} (tol {gn_tol:.3e}; the CPU's "
          f"own grad_norm moves {sens:.3e} when the input moves 1e-6)")


def labels_card_vs_cpu(dev, card, work):
    """Phase 8: the train labels of 6 ROIs (2 frames of 3 cubes, lm13's
    64² labels, K = 32) on the card and on the CPU, from the same boxes:
    with GT xyz maps through ``gt_labels``, without them through the
    depth surface and ``surface_labels``; ``region_label`` in neither.
    Returns each kernel's launches in its own run (``region_label``'s over
    both)."""
    import torch

    from rdpn6d_tpu_torch.data.pipeline import (
        dzi_jitter,
        preprocess_rois_grouped,
    )
    from rdpn6d_tpu_torch.ops import cuda_build

    cfg = train_config(amp=False, out_dir=os.path.join(work, "phase8"))
    launches = {"region_label": 0}
    for kernel, ship_xyz in (("gt_labels", True), ("surface_labels", False)):
        frames, rois = train_inputs(cfg, 40, 2, 3, ship_xyz=ship_xyz)
        frames = {k: torch.from_numpy(v) for k, v in frames.items()}
        rois = {k: torch.from_numpy(v) for k, v in rois.items()}
        box = dzi_jitter(rois["bbox"], (480, 640),
                         pad_scale=cfg.data.dzi_pad_scale)
        on_dev = [{k: v.to(dev) for k, v in d.items()} for d in (frames, rois)]
        box_dev = tuple(t.to(dev) for t in box)
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        card_out = preprocess_rois_grouped(cfg, *on_dev, train=True,
                                           center_scale=box_dev)
        torch.cuda.synchronize()
        launches[kernel] = cuda_build.LAUNCHES.get(kernel, 0)
        launches["region_label"] += cuda_build.LAUNCHES.get("region_label", 0)
        check(launches[kernel] >= 1, f"{kernel} was not launched on the "
              "train labels' path")
        check(launches["region_label"] == 0, "region_label was launched on "
              "the train labels' path")
        cpu_out = preprocess_rois_grouped(cfg, frames, rois, train=True,
                                          center_scale=box)
        card_out = {k: v.cpu() for k, v in card_out.items()}
        for k in ("roi_mask_visib", "roi_mask_obj", "roi_mask_trunc"):
            check(torch.equal(card_out[k], cpu_out[k]),
                  f"labels {kernel}: {k} card vs CPU differ")
        same = card_out["roi_region"] == cpu_out["roi_region"]
        agree = float(same.float().mean())
        # both kernels take the plain versions' taps and distance form
        # (surface_labels every op of its back-projection too); the bound
        # leaves room for a near-tie that a CPU library op rounds apart
        check(agree >= 0.999, f"labels {kernel}: ids agree on {agree:.5f}")
        err = float((card_out["roi_xyz"] - cpu_out["roi_xyz"]).abs()[same]
                    .max())
        check(err <= 1e-5, f"labels {kernel}: coords differ by {err:.3e}")
        fg = float(cpu_out["roi_mask_obj"].mean())
        check(fg > 0.05, f"labels {kernel}: crops hold {fg:.3f} object")
        print(f"labels: {'xyz maps' if ship_xyz else 'depth surface'} -> "
              f"{kernel} x{launches[kernel]}: card vs CPU masks equal, ids "
              f"agree on {agree:.5f} of {same.numel()} px, coord max diff "
              f"{err:.3e} (tol 1e-5), object share {fg:.3f} [{card}]")
    return launches


def min_dist2_eval_shape(dev, card, n_points):
    """``min_dist2`` at the eval shapes, with the plain version and
    ``cdist``: the largest per-object launch of phase 9 (its ROIs of one
    object x the eval bank's points), and LM-13's full split (~1k ROIs an
    object), where ``cdist``'s distance matrix is taken over chunks of
    ROIs and their times summed."""
    import torch

    from rdpn6d_tpu_torch.ops.min_dist import min_dist2, min_dist2_plain

    def pair(B, seed):
        g = torch.Generator().manual_seed(seed)
        shift = torch.tensor([0.0, 0.0, 0.9])
        return [(torch.randn(B, n_points, 3, generator=g) * 0.05 + shift)
                .to(dev) for _ in range(2)]

    def report(what, a, b, iters, plain_ms, lib_ms):
        ms = cuda_ms(lambda: min_dist2(a, b), iters=iters)
        dev_ms = queued_ms(lambda: min_dist2(a, b), iters=iters)
        bound_ms, by = min_dist2_bound(a.shape[0], n_points, n_points)
        print(f"eval: min_dist2 {a.shape[0]}x{n_points}x{n_points} ({what}; "
              f"{min_dist2_plan(a, b)}) kernel {dev_ms:.4f} ms device time "
              f"({100 * bound_ms / dev_ms:.1f}% of bound), {ms:.4f} ms a "
              f"call by CUDA events over a burst of {iters}, plain "
              f"{plain_ms:.4f} ms, cdist {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}) [{card}]")

    a, b = pair(EVAL_FRAMES_PER_OBJ, 1)
    report("phase 9's largest per-object launch", a, b, 50,
           cuda_ms(lambda: min_dist2_plain(a, b), iters=5, warmup=1),
           cuda_ms(lambda: torch.cdist(a, b).square().amin(-1), iters=10))
    a, b = pair(EVAL_SPLIT_ROIS, 2)
    rois = 50        # a 1.8 GB distance matrix a chunk

    def chunked_cdist():
        for i in range(0, EVAL_SPLIT_ROIS, rois):
            torch.cdist(a[i:i + rois], b[i:i + rois]).square().amin(-1)

    report("one object of LM-13's full test split", a, b, 10,
           cuda_ms(lambda: min_dist2_plain(a, b), iters=1, warmup=1),
           cuda_ms(chunked_cdist, iters=1, warmup=1))


def time_png_decode(root, card):
    """Host decode time of the tree's frames (written with filter 0), and
    of one RGB frame re-written with the Paeth filter on every row (the
    slowest filter; files written by other encoders mix the five)."""
    import glob

    from rdpn6d_tpu_torch.data import png

    rgb = sorted(glob.glob(os.path.join(root, "lm/test/*/rgb/*.png")))
    depth = sorted(glob.glob(os.path.join(root, "lm/test/*/depth/*.png")))
    ms = {}
    for name, files, fn in (("rgb", rgb, png.imread_rgb),
                            ("depth", depth, png.imread_unchanged)):
        t0 = time.perf_counter()
        for f in files:
            fn(f)
        ms[name] = 1e3 * (time.perf_counter() - t0) / len(files)
    paeth = os.path.join(root, "paeth.png")
    png.write_png(paeth, png.imread_rgb(rgb[0]), filter_type=4)
    t0 = time.perf_counter()
    for _ in range(3):
        png.imread_rgb(paeth)
    ms["rgb_paeth"] = 1e3 * (time.perf_counter() - t0) / 3
    print(f"eval: host PNG decode of {len(rgb)} 480x640 frames: RGB "
          f"{ms['rgb']:.2f} ms/frame, 16-bit depth {ms['depth']:.2f} "
          f"ms/frame, together {ms['rgb'] + ms['depth']:.2f} ms/frame; an RGB "
          f"frame with Paeth rows {ms['rgb_paeth']:.1f} ms [{card}]")


def read_csv(path):
    rows = [ln.split(",") for ln in open(path).read().splitlines()[1:]]
    return ([tuple(r[:4]) for r in rows],
            np.array([[float(x) for x in r[4].split()] for r in rows]),
            np.array([[float(x) for x in r[5].split()] for r in rows]))


def run_eval_phase(dev, card, work):
    """Phase 9: the eval entry point on an LM tree written under
    ``work/data``; returns ``min_dist2``'s launches in ``main``'s run and
    its MEAN table."""
    import torch

    from rdpn6d_tpu_torch import main as port_main
    from rdpn6d_tpu_torch.configs import lm13
    from rdpn6d_tpu_torch.data.bop import Split, register_split
    from rdpn6d_tpu_torch.data.refs import LM, LM13_OBJECTS
    from rdpn6d_tpu_torch.data.synthetic import write_lm_tree
    from rdpn6d_tpu_torch.engine.checkpoint import CheckpointManager
    from rdpn6d_tpu_torch.engine.eval_runner import run_eval
    from rdpn6d_tpu_torch.models import RDPN, init_weights
    from rdpn6d_tpu_torch.ops import cuda_build
    from rdpn6d_tpu_torch.parallel import create_train_state

    objs = {o: LM.obj2id[o] for o in LM13_OBJECTS}
    n_rois = len(objs) * EVAL_FRAMES_PER_OBJ
    t0 = time.perf_counter()
    write_lm_tree(os.path.join(work, "data"), objs, EVAL_FRAMES_PER_OBJ,
                  seed=9)
    print(f"eval: wrote an LM tree of {len(objs)} objects x "
          f"{EVAL_FRAMES_PER_OBJ} frames in "
          f"{time.perf_counter() - t0:.1f} s (host, set-up)")
    time_png_decode(os.path.join(work, "data"), card)
    os.environ["RDPN6D_DATA_ROOT"] = os.path.join(work, "data")

    cfg = lm13.get_config()
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(4))
    with torch.no_grad():      # poses ~1 m away, as physical_z does
        model.pnp_net.fc_t.bias[2] = 2.0
    out = os.path.join(work, "out")
    CheckpointManager(os.path.join(out, "ckpt")).save(
        0, create_train_state(cfg, model))

    torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    res = port_main.main([
        "--config-file",
        os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "lm13.py"),
        "--eval-only", "--opts", f'train.output_dir="{out}"'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_build.LAUNCHES.get("min_dist2", 0)
    check(list(res) == ["lm_13_test"], f"main evaluated {list(res)}")
    res = res["lm_13_test"]
    check(launches == len(objs), f"min_dist2 launched {launches} times "
          f"for {len(objs)} scored objects")
    ident, R, t = read_csv(os.path.join(out, "lm_13_test_bop19.csv"))
    check(len(ident) == n_rois, f"CSV has {len(ident)} rows for "
          f"{n_rois} instances")
    check(bool(np.isfinite(R).all() and np.isfinite(t).all()),
          "non-finite poses in the CSV")
    curves = sorted(os.listdir(os.path.join(out, "plots_lm_13_test")))
    check("recall_ad.csv" in curves and "recall_adi.csv" in curves,
          f"recall curves: {curves}")
    log = open(os.path.join(out, "log.txt")).read()
    check("MEAN" in log and all(o in log for o in LM13_OBJECTS),
          "the per-object table is not in the log")
    check(set(res["per_obj"]) == set(LM13_OBJECTS),
          f"per-object table covers {sorted(res['per_obj'])}")
    st = res["stats"]
    check(st["n_rois"] == n_rois and st["n_timed"] > 0
          and st["wall_s"] > 0, f"inference stats {st}")
    rate = st["n_timed"] / st["wall_s"]
    print(f"eval: lm13 full width bf16 main --eval-only on lm_13_test: "
          f"{st['n_rois']} ROIs, {rate:.1f} poses/s over the "
          f"{st['n_timed']} ROIs past warm-up ({st['wall_s']:.3f} s), "
          f"split wall time {wall:.2f} s (records, assets, checkpoint, "
          f"decode, model, scoring, CSV, curves); min_dist2 x{launches}; "
          f"MEAN ad_10 {res['mean']['ad_10']:.2f} [{card}]")

    register_split(Split("lm_13_test_2obj", "lm", "test",
                         objs=LM13_OBJECTS[:2], filter_invalid=False,
                         per_obj_index="image_set/{obj}_test.txt"))
    f32 = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        path = os.path.join(out, f"f32_{name}.csv")
        r = run_eval(cfg, os.path.join(out, "ckpt"), "lm_13_test_2obj",
                     csv_path=path, dtype=torch.float32, device=d)
        f32[name] = (read_csv(path), r["errors"])
    (c_id, c_R, c_t), c_err = f32["card"]
    (p_id, p_R, p_t), p_err = f32["cpu"]
    check(c_id == p_id, "f32 eval: CSV identity columns differ")
    dR = float(np.abs(c_R - p_R).max())
    dt = float((np.abs(c_t - p_t).max(1) / np.abs(p_t).max(1)).max())
    check(dR <= 1e-3 and dt <= 1e-3, f"f32 eval: card vs CPU poses "
          f"|dR| {dR:.3e}, |dt|/|t| {dt:.3e}")
    worst = {"add": 0.0, "adi": 0.0, "re": 0.0}
    for obj, e in p_err.items():
        diam = LM.diameter_m(LM.obj2id[obj])     # the tree's cube
        for k in ("add", "adi"):
            worst[k] = max(worst[k], float(
                np.abs(c_err[obj][k] - e[k]).max() / diam))
        worst["re"] = max(worst["re"],
                          float(np.abs(c_err[obj]["re"] - e["re"]).max()))
    check(worst["add"] <= 1e-3 and worst["adi"] <= 1e-3
          and worst["re"] <= 0.1, f"f32 eval: card vs CPU errors {worst}")
    print(f"eval: f32 run_eval over {len(c_id)} ROIs of 2 objects, card "
          f"vs CPU: identity columns equal, max |dR| {dR:.3e}, max "
          f"|dt|/|t| {dt:.3e} (tol 1e-3); ADD {worst['add']:.3e} and "
          f"ADI {worst['adi']:.3e} of the diameter (tol 1e-3), re "
          f"{worst['re']:.3e} deg (tol 0.1) [{card}]")
    min_dist2_eval_shape(dev, card, cfg.loss.num_pm_points)
    return launches, res["mean"]


def instrument_trainer(rec: dict):
    """Wraps ``Trainer.train`` for phases 10 and 11, with no knob of the
    trainer's own: records the start iteration, the trunk before the first
    step and the device frame cache (the object behind
    ``aux_metrics_fn``), times each ``next()`` on the loaders (TRAIN2's
    too, in iteration order) and, through ``step_hook``, each step (to a
    synchronize) and the cache's counts after it. Returns a function that
    undoes the wrapping."""
    import torch

    from rdpn6d_tpu_torch.engine.trainer import Trainer

    orig = Trainer.train

    def train(self, loader, start_iter=0, **kw):
        cache = getattr(kw.get("aux_metrics_fn"), "__self__", None)
        rec.update(start_iter=start_iter, cache=cache, waits=[], stamps=[],
                   counts=[], trunk={k: v.detach().cpu().clone() for k, v
                                     in self.model.backbone.state_dict()
                                     .items()})

        def timed(source):
            while True:
                t0 = time.perf_counter()
                batch = next(source)
                rec["waits"].append(time.perf_counter() - t0)
                yield batch

        def hook(it, metrics):
            torch.cuda.synchronize()
            rec["stamps"].append(time.perf_counter())
            rec["counts"].append((cache.hits, cache.misses) if cache
                                 else (0, 0))

        if kw.get("loader2") is not None:
            kw["loader2"] = timed(kw["loader2"])
        torch.cuda.synchronize()
        rec["t0"] = time.perf_counter()
        return orig(self, timed(loader), start_iter=start_iter,
                    step_hook=hook, **kw)

    Trainer.train = train
    return lambda: setattr(Trainer, "train", orig)


def decode_rate(cfg, splits, assets, workers: int) -> float:
    """Frames a second that the decode pool delivers from a cold start
    (a decoder of its own, so no frame is cached on the host): the time
    to the DECODE_BATCHES-th batch of ``train_group_iterator``, which holds
    DECODE_BATCHES x 24 frames of the first epoch (LM: one instance a
    frame), batched as the trainer takes them."""
    from rdpn6d_tpu_torch.data.loader import (
        RecordDecoder,
        train_group_iterator,
    )

    decoder = RecordDecoder(cfg, assets, train=True)
    t0 = time.perf_counter()
    it = train_group_iterator(cfg, splits, decoder=decoder, seed=5,
                              num_workers=workers, yield_keys=True)
    n = 0
    for _ in range(DECODE_BATCHES):
        n += len({k for k, _ in next(it)["frame_slots"]})
    secs = time.perf_counter() - t0
    it.close()
    return n / secs


def held_batches_ms(cfg, splits, assets, dev, work) -> float:
    """Phase 10's train loop with its batches held in host memory and the
    decode pool stopped: 12 batches of ``train_group_iterator``, fed
    through a device frame cache to ``Trainer.train`` as ``main`` feeds
    them, twice round; each step timed to a synchronize. Returns the
    median ms over the second round (every frame cached, as in epoch 2),
    to set beside epoch 2's with the pool running."""
    import torch

    from rdpn6d_tpu_torch.data.device_cache import DeviceFrameCache
    from rdpn6d_tpu_torch.data.loader import (
        RecordDecoder,
        train_group_iterator,
    )
    from rdpn6d_tpu_torch.engine.trainer import Trainer
    from rdpn6d_tpu_torch.models import RDPN, init_weights

    it = train_group_iterator(cfg, splits, seed=3, yield_keys=True,
                              decoder=RecordDecoder(cfg, assets, train=True))
    held = [next(it) for _ in range(12)]
    it.close()
    cache = DeviceFrameCache(cfg.data.device_frame_cache_mb << 20, dev)

    def feed():
        for gb in itertools.cycle(held):
            yield {"frames": cache.stack(gb["frame_slots"]),
                   "rois": gb["rois"]}

    cfg = cfg.apply_opts([f'train.output_dir="{os.path.join(work, "held")}"',
                          "train.checkpoint_period_epochs=1e9"])
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(0))
    stamps = []

    def hook(it, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    Trainer(cfg, model, total_iters=2 * len(held), device=dev).train(
        feed(), step_hook=hook)
    return float(np.median(1e3 * np.diff(stamps[len(held) - 1:])))


def run_train_from_disk(dev, card, work, profile: bool):
    """Phase 10: ``main`` trains lm13 from the trees under ``work/data``,
    then resumes; returns each kernel's launches over both runs. With
    ``profile``, also times the loop on held batches."""
    import torch

    from rdpn6d_tpu_torch import main as port_main
    from rdpn6d_tpu_torch.config import load_config
    from rdpn6d_tpu_torch.data.assets import load_class_assets
    from rdpn6d_tpu_torch.data.loader import default_num_workers
    from rdpn6d_tpu_torch.data.refs import LM, LM13_OBJECTS
    from rdpn6d_tpu_torch.data.synthetic import (
        write_lm_imgn_tree,
        write_resnet_pth,
    )
    from rdpn6d_tpu_torch.ops import cuda_build

    objs = {o: LM.obj2id[o] for o in LM13_OBJECTS}
    data = os.path.join(work, "data")
    t0 = time.perf_counter()
    write_lm_imgn_tree(data, objs, IMGN_FRAMES_PER_OBJ, seed=10)
    pth = write_resnet_pth(os.path.join(work, "pretrained",
                                        "resnet34-seeded.pth"), 34, seed=11)
    os.environ["RDPN6D_PRETRAINED_DIR"] = os.path.dirname(pth)
    print(f"train from disk: wrote an lm_imgn tree of {len(objs)} objects "
          f"x {IMGN_FRAMES_PER_OBJ} frames and a seeded ResNet-34 .pth in "
          f"{time.perf_counter() - t0:.1f} s (host, set-up)")
    config = os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "lm13.py")
    out = os.path.join(work, "train")
    opts = ["train.log_period=1", "train.checkpoint_period_epochs=1",
            f"train.eval_period={TRAIN_EPOCHS * ITERS_PER_EPOCH}",
            f'train.output_dir="{out}"']
    cfg = load_config(config, opts)
    check(cfg.backbone.pretrained == "torchvision://resnet34"
          and cfg.solver.ims_per_batch == TRAIN_ROIS and cfg.solver.amp
          and cfg.data.grouped_train and cfg.data.ship_crops
          and cfg.data.device_frame_cache_mb == 1024,
          "phase 10 does not run lm13's own train settings")

    launches, runs = {}, []
    for epochs, resume in ((TRAIN_EPOCHS, False), (RESUME_EPOCHS, True)):
        rec: dict = {}
        undo = instrument_trainer(rec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        try:
            state = port_main.main(
                ["--config-file", config] + ["--resume"] * resume
                + ["--opts", *opts, f"solver.total_epochs={epochs}"])
        finally:
            undo()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(cuda_build.LAUNCHES)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        rec.update(wall=wall, launches=got, state=state,
                   peak=torch.cuda.max_memory_allocated())
        runs.append(rec)

    first, second = runs
    lines = [json.loads(ln) for ln in open(os.path.join(out, "metrics.json"))]
    per_epoch = ITERS_PER_EPOCH
    total = per_epoch * RESUME_EPOCHS
    check(len(first["stamps"]) == per_epoch * TRAIN_EPOCHS
          and first["start_iter"] == 0,
          f"{len(first['stamps'])} iterations from {first['start_iter']}")
    check(second["start_iter"] == per_epoch * TRAIN_EPOCHS
          and len(second["stamps"]) == total - second["start_iter"]
          and second["state"].step == total,
          f"the resumed run started at {second['start_iter']}, ran "
          f"{len(second['stamps'])} iterations to step "
          f"{second['state'].step}")
    check([ln["iteration"] for ln in lines] == list(range(1, total + 1)),
          f"metrics.json iterations {[ln['iteration'] for ln in lines]}")
    bad = [(ln["iteration"], k) for ln in lines for k, v in ln.items()
           if (k.startswith("loss") or k in ("total_loss", "grad_norm"))
           and not np.isfinite(v)]
    check(not bad, f"non-finite logged losses {bad[:5]}")
    steps = sorted(int(d) for d in os.listdir(os.path.join(out, "ckpt")))
    check(steps == [per_epoch * e for e in range(1, RESUME_EPOCHS + 1)],
          f"checkpoints {steps}")
    sd = torch.load(pth, weights_only=True)
    trunk = first["trunk"]
    check(all(torch.equal(trunk[k], v) for k, v in sd.items()
              if not k.startswith("fc.")), "the trunk before the first step "
          "is not the .pth's")
    trained = first["state"].model.backbone.state_dict()
    check(all(torch.equal(v, trained[k].cpu())
              for k, v in second["trunk"].items())
          and not all(torch.equal(second["trunk"][k], v)
                      for k, v in sd.items() if not k.startswith("fc.")),
          "the resumed run's trunk is not the checkpoint's")
    for r, n in ((first, per_epoch * TRAIN_EPOCHS),
                 (second, total - per_epoch * TRAIN_EPOCHS)):
        check(r["launches"].get("gt_labels", 0) == n,
              f"gt_labels launched {r['launches'].get('gt_labels', 0)} "
              f"times in {n} iterations")
        check(r["launches"].get("surface_labels", 0) == 0
              and r["launches"].get("region_label", 0) == 0,
              "surface_labels or region_label launched: the xyz crops were "
              "not shipped")
    check(first["launches"].get("min_dist2", 0) == len(objs),
          f"min_dist2 launched {first['launches'].get('min_dist2', 0)} "
          f"times for {len(objs)} evaluated objects")
    ident, R, t = read_csv(os.path.join(out, "lm_13_test_bop19.csv"))
    check(len(ident) == len(objs) * EVAL_FRAMES_PER_OBJ
          and bool(np.isfinite(R).all() and np.isfinite(t).all()),
          f"eval during training: {len(ident)} CSV rows")
    counts = first["counts"]
    hits2 = counts[-1][0] - counts[per_epoch - 1][0]
    miss2 = counts[-1][1] - counts[per_epoch - 1][1]
    # 6 iterations of 24 take 144 of the 156 frames: the second epoch of
    # iterations meets 12 of them first
    check(hits2 > 0, f"second epoch: {hits2} cache hits, {miss2} misses")

    step_ms = 1e3 * np.diff([first["t0"]] + first["stamps"])
    wait_ms = 1e3 * np.asarray(first["waits"])
    cache = first["cache"]
    print(f"train from disk: lm13 full width bf16 autocast, {TRAIN_ROIS} "
          f"ROIs/step, trunk from the .pth: {len(step_ms)} iterations in "
          f"{first['wall']:.2f} s of main (records, model, "
          f"{TRAIN_EPOCHS} checkpoints, eval of "
          f"{len(ident)} ROIs); ms/step median {np.median(step_ms):.2f} "
          f"over all, epoch 1 {np.median(step_ms[:per_epoch]):.2f}, epoch "
          f"2 {np.median(step_ms[per_epoch:]):.2f}; loader wait ms/step "
          f"median {np.median(wait_ms):.2f}, epoch 1 "
          f"{np.median(wait_ms[:per_epoch]):.2f}, epoch 2 "
          f"{np.median(wait_ms[per_epoch:]):.2f}; peak memory "
          f"{first['peak'] / 2**30:.2f} GiB [{card}]")
    print(f"train from disk: device frame cache {cache.hits} hits, "
          f"{cache.misses} misses, {len(cache)} frames, "
          f"{cache.resident_bytes / 2**20:.1f} MB resident; second epoch "
          f"{hits2} hits, {miss2} misses; launches {first['launches']} "
          f"[{card}]")
    print(f"train from disk: --resume from step {second['start_iter']} to "
          f"{second['state'].step}: {len(second['stamps'])} iterations, "
          f"wall {second['wall']:.2f} s, ms/step median "
          f"{np.median(1e3 * np.diff([second['t0']] + second['stamps'])):.2f}"
          f", launches {second['launches']} [{card}]")
    splits = list(cfg.data.train_datasets)
    assets = load_class_assets(LM, cfg.head.num_regions,
                               cfg.loss.num_pm_points, objs=LM13_OBJECTS)
    default = default_num_workers()
    rates = {w: decode_rate(cfg, splits, assets, w) for w in (1, default)}
    print(f"train from disk: decode pool, cold, {DECODE_BATCHES} batches of "
          f"{TRAIN_ROIS} frames: {rates[1]:.1f} frames/s at 1 worker, "
          f"{rates[default]:.1f} at {default} (the default on "
          f"{os.cpu_count()} cores); a step needs {TRAIN_ROIS} frames "
          f"[{card}]")
    if profile:
        held_ms = held_batches_ms(cfg, splits, assets, dev, work)
        print(f"train from disk: the same loop on 12 batches held in host "
              f"memory, decode pool stopped, every frame cached: ms/step "
              f"median {held_ms:.2f} (epoch 2 with the pool running "
              f"{np.median(step_ms[per_epoch:]):.2f}) [{card}]")
    return launches


def color_aug_card_vs_cpu(dev, card) -> None:
    """The "code" pipeline on 24 crops of 256x256 under one set of draws,
    on the card and on the CPU, within COLOR_AUG_TOL on the 0..255 scale;
    prints the card's ms by CUDA events."""
    import torch

    from rdpn6d_tpu_torch.data.augment import (
        color_augment,
        draw_aug_params,
        get_aug_pipeline,
    )

    ops = get_aug_pipeline("code")
    gen = torch.Generator().manual_seed(9)
    img = torch.rand(TRAIN_ROIS, 256, 256, 3, generator=gen) * 255.0
    params = draw_aug_params(ops, TRAIN_ROIS, gen, (256, 256))
    cpu = color_augment(img, params, ops)
    img_d = img.to(dev)
    params_d = [{k: v.to(dev) for k, v in p.items()} for p in params]
    err = float((color_augment(img_d, params_d, ops).cpu() - cpu).abs()
                .max())
    check(err <= COLOR_AUG_TOL, f"color_augment card vs CPU {err:.3e} "
          f"(tol {COLOR_AUG_TOL})")
    ms = cuda_ms(lambda: color_augment(img_d, params_d, ops), iters=20)
    print(f"train lmo: color_augment ('code', {TRAIN_ROIS} x 256x256) card "
          f"vs CPU max |diff| {err:.3e} (tol {COLOR_AUG_TOL}), {ms:.3f} ms "
          f"on the card [{card}]")


def lmo_host_times(data, pool, card) -> None:
    """Host decode ms a 480x640 RGB frame, the PBR split's JPEG beside the
    real split's PNG, and the background resize's ms (a 375x500 pool image
    to the frame, and a 960x1280 one through OpenCV's 2x area path)."""
    import glob

    from rdpn6d_tpu_torch.data.image import imread_rgb, resize_linear

    ms = {}
    for name, pattern in (("jpeg", "lmo/train_pbr/*/rgb/*.jpg"),
                          ("png", "lmo/train/*/rgb/*.png")):
        files = sorted(glob.glob(os.path.join(data, pattern)))
        t0 = time.perf_counter()
        for f in files:
            imread_rgb(f)
        ms[name] = 1e3 * (time.perf_counter() - t0) / len(files)
    for name, rel in (("resize", "JPEGImages/2008_000001.jpg"),
                      ("resize_2x", "JPEGImages/2008_000003.jpg")):
        bg = imread_rgb(os.path.join(pool, rel))
        t0 = time.perf_counter()
        for _ in range(5):
            resize_linear(bg, (640, 480))
        ms[name] = 1e3 * (time.perf_counter() - t0) / 5
    print(f"train lmo: host decode of a 480x640 RGB frame: JPEG (PBR, "
          f"quality 90, 4:2:0) {ms['jpeg']:.2f} ms, PNG {ms['png']:.2f} ms; "
          f"background resize to 480x640: {ms['resize']:.2f} ms from "
          f"375x500, {ms['resize_2x']:.2f} ms from 960x1280 [{card}]")


def pbr_decode_rate(cfg, assets, workers: int) -> tuple[float, int]:
    """Frames a second of the PBR split's decode pool from a cold start (a
    decoder of its own), background replacement on: distinct JPEG frames
    over the time to its second 24-ROI batch; and the composites in
    those batches."""
    from rdpn6d_tpu_torch.data.loader import (
        RecordDecoder,
        train_group_iterator,
    )

    decoder = RecordDecoder(cfg, assets, train=True)
    t0 = time.perf_counter()
    it = train_group_iterator(cfg, ["lmo_pbr_train"], decoder=decoder,
                              seed=5, num_workers=workers, yield_keys=True)
    keys, private = set(), 0
    for _ in range(2):
        slots = next(it)["frame_slots"]
        keys |= {k for k, _ in slots if k is not None}
        private += sum(k is None for k, _ in slots)
    secs = time.perf_counter() - t0
    it.close()
    return len(keys) / secs, private


def run_train_lmo(dev, card, work):
    """Phase 11: ``main`` trains lmo from an LM-O tree written under
    ``work/data`` with a background pool, then evaluates; returns each
    kernel's launches."""
    import torch

    from rdpn6d_tpu_torch import main as port_main
    from rdpn6d_tpu_torch.config import load_config
    from rdpn6d_tpu_torch.data import pipeline
    from rdpn6d_tpu_torch.data.assets import load_class_assets
    from rdpn6d_tpu_torch.data.loader import (
        default_num_workers,
        load_train_records,
    )
    from rdpn6d_tpu_torch.data.refs import LMO
    from rdpn6d_tpu_torch.data.synthetic import write_bg_pool, write_lmo_tree
    from rdpn6d_tpu_torch.ops import cuda_build

    color_aug_card_vs_cpu(dev, card)
    data = os.path.join(work, "data")
    t0 = time.perf_counter()
    write_lmo_tree(data, LMO_TRAIN_FRAMES, 1, LMO_PBR_FRAMES, LMO_TEST_FRAMES,
                   seed=12)
    pool = write_bg_pool(os.path.join(work, "VOC"), seed=13)
    print(f"train lmo: wrote an LM-O tree ({LMO_TRAIN_FRAMES} real, "
          f"{LMO_PBR_FRAMES} PBR JPEG and {LMO_TEST_FRAMES} test frames of 8 "
          f"occluding cubes) and a background pool in "
          f"{time.perf_counter() - t0:.1f} s (host, set-up)")
    lmo_host_times(data, pool, card)
    check(bool(os.environ.get("RDPN6D_PRETRAINED_DIR")),
          "phase 11 needs phase 10's seeded .pth")
    config = os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "lmo.py")
    out = os.path.join(work, "lmo")
    opts = ["train.log_period=1", "train.checkpoint_period_epochs=1e9",
            f"data.train2_ratio={LMO_TRAIN2_RATIO}",
            f'data.bg_images_dir="{pool}"', f'train.output_dir="{out}"',
            f"solver.total_epochs={LMO_EPOCHS}"]
    cfg = load_config(config, opts)
    d = cfg.data
    check(cfg.backbone.pretrained == "torchvision://resnet34"
          and cfg.backbone.depth == 34 and cfg.solver.ims_per_batch == 24
          and cfg.solver.amp and cfg.head.num_classes == 8
          and cfg.head.num_regions == 32 and d.color_aug_prob == 0.8
          and d.color_aug_type == "code" and d.change_bg_prob == 0.5
          and d.truncate_fg and d.train2_datasets == ("lmo_pbr_train",),
          "phase 11 does not run lmo's own train settings")
    n_records = len(load_train_records(cfg, list(d.train_datasets)))
    iters = n_records // TRAIN_ROIS * LMO_EPOCHS
    rng = np.random.RandomState(cfg.train.seed)
    pbr_its = [i for i in range(iters) if rng.rand() < LMO_TRAIN2_RATIO]
    opts.append(f"train.eval_period={iters}")

    applied = []
    draw = pipeline.draw_color_aug

    def recording_draw(*a, **kw):
        out_ = draw(*a, **kw)
        applied.append(out_["apply"])
        return out_

    rec: dict = {}
    undo = instrument_trainer(rec)
    pipeline.draw_color_aug = recording_draw
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    try:
        state = port_main.main(["--config-file", config, "--opts", *opts])
    finally:
        undo()
        pipeline.draw_color_aug = draw
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    check(state.step == iters and len(rec["stamps"]) == iters,
          f"{len(rec['stamps'])} iterations to step {state.step}, "
          f"expected {iters}")
    lines = [json.loads(ln) for ln in open(os.path.join(out, "metrics.json"))]
    check([ln["iteration"] for ln in lines] == list(range(1, iters + 1)),
          f"metrics.json iterations {[ln['iteration'] for ln in lines]}")
    bad = [(ln["iteration"], k) for ln in lines for k, v in ln.items()
           if (k.startswith("loss") or k in ("total_loss", "grad_norm"))
           and not np.isfinite(v)]
    check(not bad, f"non-finite logged losses {bad[:5]}")
    n_pbr = len(pbr_its)
    check(0 < n_pbr < iters, f"{n_pbr} PBR iterations of {iters}")
    check(launches.get("gt_labels", 0) == iters - n_pbr
          and launches.get("surface_labels", 0) == n_pbr
          and launches.get("region_label", 0) == 0,
          f"label launches {launches} for {iters - n_pbr} real-split and "
          f"{n_pbr} PBR iterations")
    targets = json.load(open(os.path.join(data, "lmo",
                                          "test_targets_bop19.json")))
    n_objs = len({t["obj_id"] for t in targets})
    check(launches.get("min_dist2", 0) == n_objs,
          f"min_dist2 launched {launches.get('min_dist2', 0)} times for "
          f"{n_objs} evaluated objects")
    ident, R, t = read_csv(os.path.join(out, "lmo_bop_test_bop19.csv"))
    check(len(ident) == len(targets)
          and bool(np.isfinite(R).all() and np.isfinite(t).all()),
          f"eval: {len(ident)} CSV rows for {len(targets)} targets")
    cache = rec["cache"]
    check(cache is not None and cache.private > 0 and None not in cache,
          "no private (background-replaced) frame streamed, or one stayed "
          "in the device cache")
    on = torch.cat([a.cpu() for a in applied]).float()
    share = float(on.mean())
    sigma = float(np.sqrt(0.8 * 0.2 / on.numel()))
    check(len(applied) == iters and abs(share - 0.8) <= 5 * sigma,
          f"colour aug on {share:.3f} of {on.numel()} ROIs (0.8 +- "
          f"{5 * sigma:.3f})")

    step_ms = 1e3 * np.diff([rec["t0"]] + rec["stamps"])
    wait_ms = 1e3 * np.asarray(rec["waits"])
    pbr = np.isin(np.arange(iters), pbr_its)
    print(f"train lmo: lmo full width bf16 autocast, {TRAIN_ROIS} ROIs/step, "
          f"{n_records} lmo_train records, {iters} iterations ({n_pbr} on "
          f"lmo_pbr_train) in {wall:.2f} s of main (records, model, trunk, "
          f"1 checkpoint, eval of {len(ident)} targets); ms/step median "
          f"{np.median(step_ms):.2f}, real split "
          f"{np.median(step_ms[~pbr]):.2f}, PBR {np.median(step_ms[pbr]):.2f}; loader wait ms/step median "
          f"{np.median(wait_ms):.2f}, real {np.median(wait_ms[~pbr]):.2f}, "
          f"PBR {np.median(wait_ms[pbr]):.2f}; peak memory "
          f"{peak / 2**30:.2f} GiB [{card}]")
    print(f"train lmo: colour aug on {share:.3f} of {on.numel()} ROIs (0.8 "
          f"+- {5 * sigma:.3f}); {cache.private} private frames streamed; "
          f"device frame cache {cache.hits} hits, {cache.misses} misses, "
          f"{len(cache)} frames; launches {launches} [{card}]")
    assets = load_class_assets(LMO, cfg.head.num_regions,
                               cfg.loss.num_pm_points)
    default = default_num_workers()
    rates = {w: pbr_decode_rate(cfg, assets, w) for w in (1, default)}
    print(f"train lmo: PBR decode pool, cold, background replacement on, 2 "
          f"batches of {TRAIN_ROIS} ROIs: {rates[1][0]:.2f} frames/s at 1 "
          f"worker, {rates[default][0]:.2f} at {default} (the default on "
          f"{os.cpu_count()} cores), {rates[1][1]} composites [{card}]")
    return launches


INT8_OPS_PER_S = 1979e12     # H100 SXM dense int8 tensor-core ops/s
BF16_FLOPS_PER_S = 989e12    # ... and dense bf16, cuDNN's yardstick
# (label, B, H, W, C_in, C_out, k, stride, pad): lm13's head at the serving
# batch of 16 (320 input channels after rot_concat's skip, then 256), one
# conv per trunk stage at 256² ROIs (3x3 at stride 1 and 2, a 1x1 stride-2
# downsample), K of one 32-byte wgmma step (a quarter slab), N past a
# 256-wide tile and between widths, and ragged M (tiles across samples)
# and C_in not a multiple of 32
INT8_HEAD = [("head 320->256 3x3", 16, 64, 64, 320, 256, 3, 1, 1),
             ("head 256->256 3x3", 16, 64, 64, 256, 256, 3, 1, 1)]
INT8_SHAPES = INT8_HEAD + [
    ("stage1 64->64 3x3", 16, 64, 64, 64, 64, 3, 1, 1),
    ("stage2 64->128 3x3/2", 16, 64, 64, 64, 128, 3, 2, 1),
    ("stage2 64->128 1x1/2", 16, 64, 64, 64, 128, 1, 2, 0),
    ("stage3 128->256 3x3/2", 16, 32, 32, 128, 256, 3, 2, 1),
    ("stage4 256->512 3x3/2", 16, 16, 16, 256, 512, 3, 2, 1),
    ("K 32 1x1 32->40", 2, 9, 13, 32, 40, 1, 1, 0),
    ("ragged N 64->257 3x3", 2, 12, 12, 64, 257, 3, 1, 1),
    ("ragged N 96->192 3x3", 3, 7, 9, 96, 192, 3, 1, 1),
    ("ragged 40->24 3x3", 3, 7, 9, 40, 24, 3, 1, 1),
    ("ragged 8->130 3x3/2", 1, 5, 5, 8, 130, 3, 2, 1)]
INT8_MODES = {"dynamic": False, "static": True,
              "per_channel": "per_channel"}


def int8_conv_bound(B, H, W, C, N, k, stride, pad) -> tuple[float, str]:
    """Least ms for ``int8_conv`` at this shape with bfloat16 output: its
    2 M N K int8 operations (K = k² C) over the card's int8 rate, or xq and
    wq (channels padded to 32) and sx, sw read once and the output written
    once over its memory rate, the larger."""
    from rdpn6d_tpu_torch.ops.int8_conv import conv_out_size, padded_channels

    Ho, Wo = (conv_out_size(H, k, stride, pad),
              conv_out_size(W, k, stride, pad))
    cp = padded_channels(C)
    ops_s = 2.0 * B * Ho * Wo * N * k * k * C / INT8_OPS_PER_S
    bytes_s = (B * H * W * cp + N * k * k * cp + 4 * (B + N)
               + 2 * B * N * Ho * Wo) / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), \
        "operations" if ops_s >= bytes_s else "bytes"


def quantize_act_bound(B, C, H, W) -> tuple[float, str]:
    """Least ms for ``quantize_act`` of bfloat16 x: x read once, xq (padded
    to 32 channels) and sx written once (a divide and a round an element
    are far below the card's rate)."""
    from rdpn6d_tpu_torch.ops.int8_conv import padded_channels

    return 1e3 * (2 * B * C * H * W + B * H * W * padded_channels(C)
                  + 4 * B) / HBM_BYTES_PER_S, "bytes"


def int8_activations(B, C, H, W, seed, dev):
    """Post-BN/ReLU-like bfloat16 activations, channels of unlike ranges."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, C, H, W, generator=g) \
        * (torch.rand(C, generator=g) * 3)[None, :, None, None]
    return x.clamp_min(-0.3).to(dev, torch.bfloat16)


def int8_case(dev, shape, static, seed):
    """An ``Int8Conv`` of ``shape`` on the card, calibrated on its seeded
    input in the given mode: (x, conv, (wq, sw, amax, t))."""
    import torch

    from rdpn6d_tpu_torch.models.quant import Int8Conv, calibrate_quant

    _, B, H, W, C, N, k, stride, pad = shape
    x = int8_activations(B, C, H, W, seed, dev)
    g = torch.Generator().manual_seed(seed + 1)
    conv = Int8Conv(C, N, k, stride, pad, static)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(N, C, k, k, generator=g)
                          * (2.0 / (C * k * k)) ** 0.5)
    conv = conv.to(dev, torch.bfloat16)
    if static:
        calibrate_quant(conv, [x])
    return x, conv, conv.quantized()


def check_int8(dev, card):
    """Phase 12 (a) and (d): each kernel against its plain version on the
    card, in every mode at every shape of ``INT8_SHAPES`` (xq, scales and
    the output bit-equal), and the two kernels' times at the head shapes
    beside their bounds, the plain versions, cuDNN's bf16 convolution and
    ``torch._int_mm`` over ``F.unfold``. Returns (conv max_abs_err,
    quantize max_abs_err, conv times, quantize times) for the kernels
    line (times of the first head shape, static mode, bf16 out)."""
    import torch
    import torch.nn.functional as F

    from rdpn6d_tpu_torch.ops.int8_conv import (
        int8_conv,
        int8_conv_plain,
        quantize_act,
        quantize_act_plain,
    )

    conv_err = quant_err = 0.0
    for i, shape in enumerate(INT8_SHAPES):
        for mode, static in INT8_MODES.items():
            x, conv, (wq, sw, amax, t) = int8_case(dev, shape, static,
                                                    100 + i)
            xq, sx = quantize_act(x, mode, amax, t)
            rq, rs = quantize_act_plain(x, mode, amax, t)
            _, _, _, _, _, _, _, stride, pad = shape
            out = int8_conv(xq, sx, wq, sw, stride, pad, torch.bfloat16)
            ref = int8_conv_plain(rq, rs, wq, sw, stride, pad,
                                  torch.bfloat16)
            torch.cuda.synchronize()
            q_err = float((xq.int() - rq.int()).abs().max()) \
                + float((sx - rs).abs().max())
            c_err = float((out.float() - ref.float()).abs().max())
            check(torch.equal(xq, rq) and torch.equal(sx, rs),
                  f"quantize_act {mode} at {shape[0]}: xq or sx differ "
                  f"from the plain version's")
            check(torch.equal(out, ref), f"int8_conv {mode} at {shape[0]}: "
                  f"max_abs_err {c_err:.3e} against the plain version")
            conv_err, quant_err = max(conv_err, c_err), max(quant_err, q_err)
        print(f"kernel: int8_conv + quantize_act {shape[0]} B={shape[1]} "
              f"{shape[2]}x{shape[3]}, dynamic / static / per_channel: xq, "
              "sx and outputs bit-equal to the plain versions")
    # a NaN in sample 0 after calibration: the dynamic scale and that
    # sample's output NaN, the NaN quantized to 0, as the plain version
    # (and XLA) has it
    shape = INT8_SHAPES[-2]
    for mode, static in INT8_MODES.items():
        x, conv, (wq, sw, amax, t) = int8_case(dev, shape, static, 7)
        x[0, 3, 2, 4] = float("nan")
        xq, sx = quantize_act(x, mode, amax, t)
        rq, rs = quantize_act_plain(x, mode, amax, t)
        out = int8_conv(xq, sx, wq, sw, 1, 1, torch.bfloat16)
        ref = int8_conv_plain(rq, rs, wq, sw, 1, 1, torch.bfloat16)
        torch.cuda.synchronize()
        same = all(torch.equal(a.isnan(), b.isnan())
                   and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
                   for a, b in ((sx, rs), (out, ref)))
        check(torch.equal(xq, rq) and same and int(xq[0, 2, 4, 3]) == 0
              and bool(out[0].isnan().all()) == (mode == "dynamic")
              and bool(out[1:].isfinite().all()),
              f"int8 kernels with a NaN input, {mode}: not as the plain "
              "version")
    print(f"kernel: int8_conv + quantize_act {shape[0]} with a NaN in "
          "sample 0, dynamic / static / per_channel: as the plain versions "
          "(dynamic: the sample's output NaN; static: the NaN quantized "
          "to 0)")

    from rdpn6d_tpu_torch.ops import cuda_build
    from rdpn6d_tpu_torch.ops.int8_conv import LIBRARY, int8_conv_plan

    _, built = cuda_build.load(LIBRARY)
    for name, u in cuda_build.ptxas_usage(built.log).items():
        if "int8_conv_kernel" in name:
            print(f"kernel: int8_conv build {name}: {u['registers']} "
                  f"registers, {u['spill_stores']} bytes spill stores, "
                  f"{u['spill_loads']} bytes spill loads, {u['smem']} bytes "
                  "static shared memory")
    times = {}
    for i, shape in enumerate(INT8_HEAD):
        label, B, H, W, C, N, k, stride, pad = shape
        x, conv, (wq, sw, amax, t) = int8_case(dev, shape, True, 100 + i)
        xq, sx = quantize_act(x, "static", amax, t)

        def run():
            return int8_conv(xq, sx, wq, sw, stride, pad, torch.bfloat16)

        ms = cuda_ms(run, iters=50)
        q_ms = queued_ms(run, iters=30)
        p_ms = device_ms(run, iters=20)
        plain_ms = cuda_ms(lambda: int8_conv_plain(
            xq, sx, wq, sw, stride, pad, torch.bfloat16), iters=3, warmup=1)
        xb, wb = x, conv.weight.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: F.conv2d(xb, wb, None, stride, pad),
                         iters=50)
        # torch._int_mm over F.unfold: im2col written out (k² C per output
        # pixel), cuBLASLt's int8 GEMM; checked against the kernel
        xqf = xq[..., :C].permute(0, 3, 1, 2).to(torch.bfloat16)
        wmat = wq[..., :C].permute(0, 3, 1, 2).reshape(N, -1).contiguous()

        def int_mm():
            cols = F.unfold(xqf, k, padding=pad, stride=stride)
            return torch._int_mm(cols.transpose(1, 2).reshape(
                -1, cols.shape[1]).to(torch.int8), wmat.t())

        acc = int_mm()
        Ho = Wo = H // stride
        y = (acc.float() * (sx.repeat_interleave(Ho * Wo)[:, None]
                            * sw[None, :])).to(torch.bfloat16)
        check(torch.equal(y.reshape(B, Ho * Wo, N).transpose(1, 2)
                          .reshape(B, N, Ho, Wo), run()),
              f"_int_mm over unfold disagrees with int8_conv at {label}")
        mm_ms = cuda_ms(int_mm, iters=20)
        cols = F.unfold(xqf, k, padding=pad, stride=stride).transpose(
            1, 2).reshape(-1, k * k * C).to(torch.int8)
        mm_only_ms = cuda_ms(lambda: torch._int_mm(cols, wmat.t()), iters=20)
        bound_ms, bound_by = int8_conv_bound(B, H, W, C, N, k, stride, pad)
        bf16_bound = 2e3 * B * Ho * Wo * N * k * k * C / BF16_FLOPS_PER_S
        q = quantize_act_bound(B, C, H, W)
        qk = cuda_ms(lambda: quantize_act(x, "static", amax, t), iters=50)
        qd = cuda_ms(lambda: quantize_act(x, "dynamic"), iters=50)
        qq = queued_ms(lambda: quantize_act(x, "static", amax, t), iters=30)
        qp = cuda_ms(lambda: quantize_act_plain(x, "static", amax, t),
                     iters=5, warmup=1)
        plan = int8_conv_plan(B, H // stride, W // stride, N,
                              k * k * xq.shape[3],
                              cuda_build.sm_count(dev.index))
        print(f"kernel: int8_conv {label} B={B} {H}x{W} bf16 out, "
              f"{plan.bn}-wide tiles, {plan.stages} stages, "
              f"{plan.smem_bytes} bytes of dynamic shared memory, grid "
              f"{plan.grid}: "
              f"{ms:.4f} ms by CUDA events ({100 * bound_ms / ms:.1f}% of "
              f"bound), device time {q_ms:.4f} (queued) / {p_ms:.4f} "
              f"(profiler); bound {bound_ms:.4f} ms ({bound_by}); plain "
              f"{plain_ms:.4f}; cuDNN bf16 F.conv2d {lib_ms:.4f} (its bound "
              f"{bf16_bound:.4f}); F.unfold + torch._int_mm {mm_ms:.4f} "
              f"(_int_mm alone {mm_only_ms:.4f}) [{card}]")
        print(f"kernel: quantize_act {C}x{H}x{W} B={B} bf16 in: static "
              f"{qk:.4f} ms by CUDA events (device time {qq:.4f} queued), "
              f"dynamic {qd:.4f}; bound {q[0]:.4f} ms ({q[1]}); plain "
              f"{qp:.4f} [{card}]")
        times[label] = ({"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": lib_ms},
                        {"ms": qk, "plain_ms": qp, "bound_ms": q[0],
                         "bound_by": q[1], "library_ms": None})
    first = times[INT8_HEAD[0][0]]
    return conv_err, quant_err, first[0], first[1]


def int8_hooks(model, feed=None):
    """Hooks on ``model``'s serving Int8Convs (not calibration passes):
    record each conv's input and output, in call order; with ``feed`` (a
    list of inputs in call order) each conv takes the fed input in place
    of its own. Returns (inputs, outputs, handles)."""
    from rdpn6d_tpu_torch.models.quant import Int8Conv

    inputs, outputs = [], []

    def pre(mod, args):
        if mod.calibrating:
            return None
        x = args[0] if feed is None else feed[len(inputs)].to(
            args[0].device)
        inputs.append(x.detach().clone())
        return None if feed is None else (x,)

    def post(mod, args, out):
        if not mod.calibrating:
            outputs.append(out.detach().clone())

    handles = []
    for m in model.modules():
        if isinstance(m, Int8Conv):
            handles += [m.register_forward_pre_hook(pre),
                        m.register_forward_hook(post)]
    return inputs, outputs, handles


# phase 12(b)'s served traffic: frames that each fill the Predictor's
# batch of 16, every mode in turns, twice round
INT8_SERVE_FRAMES = 16
INT8_SERVE_TURNS = ("bf16", "int8-head-static", "int8-head", "int8-head",
                    "int8-head-static", "bf16") * 2


def serve_counted(pred, frames, name, n_int8):
    """One served pass with the launches counted from zero: checks every
    pose finite and ``n_int8`` launches of each int8 kernel a frame (one
    batch a frame; none for a float model). Returns (poses/s, launches)."""
    from rdpn6d_tpu_torch.ops import cuda_build

    n_det = sum(len(f[2]) for f in frames)
    cuda_build.reset_launches()
    outs, secs = serve(pred, frames)
    got = dict(cuda_build.LAUNCHES)
    flat = [r for o in outs for r in o]
    check(len(flat) == n_det and all(
        np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all()
        for r in flat), f"{name}: non-finite or missing poses")
    want = n_int8 * len(frames)
    check(got.get("int8_conv", 0) == want
          and got.get("quantize_act", 0) == want,
          f"{name}: int8 launches {got}, want {want} of each")
    return n_det / secs, got


def int8_card_vs_cpu(cfg, assets, frame, card, opts, free_running):
    """Float32 (TF32 off) int8 serving card against CPU on one frame: the
    card's calibrated scales go to the CPU through the flax quant tree and
    each CPU int8 conv takes the card's input to that conv (carried), so
    every int8 conv's output is bit-equal and the poses agree within 1e-3
    as phase 5's; with ``free_running``, the CPU on its own activations
    too (reported). ``opts``: the ``test.int8`` and ``test.int8_static``
    settings."""
    import torch

    from rdpn6d_tpu_torch.engine.predictor import Predictor
    from rdpn6d_tpu_torch.models.quant import Int8Conv
    from rdpn6d_tpu_torch.ops.int8_conv import quantize_act_plain
    from rdpn6d_tpu_torch.utils.flax_params import load_quant, quant_tree

    c = cfg.apply_opts(opts)
    gp, cp = (physical_z(Predictor(c, assets, batch_size=16,
                                   dtype=torch.float32, device=d,
                                   allow_random_init=True))
              for d in ("cuda", "cpu"))
    n8 = sum(isinstance(m, Int8Conv) for m in gp.model.modules())
    rgb, depth, dets = frame
    g_in, g_out, hs = int8_hooks(gp.model)
    gpu_res = gp.predict(rgb, depth, K_LM, dets)
    for h in hs:
        h.remove()
    load_quant(cp.model, quant_tree(gp.model))
    cp._needs_calibration = False

    def pose_diff(res):
        dR = max(float(np.abs(a["R"] - b["R"]).max())
                 for a, b in zip(gpu_res, res))
        dt = max(float(np.abs(a["t"] - b["t"]).max() / np.abs(b["t"]).max())
                 for a, b in zip(gpu_res, res))
        return dR, dt

    label = f"{' '.join(opts)} f32 card vs CPU"
    c_in, c_out, hs = int8_hooks(cp.model, feed=[x.cpu() for x in g_in])
    carried = cp.predict(rgb, depth, K_LM, dets)
    for h in hs:
        h.remove()
    check(len(c_out) == len(g_out) == n8, f"{label}: {len(c_out)} CPU and "
          f"{len(g_out)} card int8 conv calls, want {n8}")
    for i, (a, b) in enumerate(zip(g_out, c_out)):
        check(torch.equal(a.cpu(), b), f"{label}: int8 conv {i}: card and "
              "CPU outputs differ on the same input")
    dR, dt = pose_diff(carried)
    print(f"parity: {label} over {len(dets)} ROIs, the card's scales and "
          f"each int8 conv's input carried to the CPU: all {n8} int8 conv "
          f"outputs bit-equal; max |dR| {dR:.3e}, max |dt|/|t| {dt:.3e} "
          f"(tol 1e-3) [{card}]")
    check(dR <= 1e-3 and dt <= 1e-3, f"{label}: poses disagree")
    if not free_running:
        return
    f_in, _, hs = int8_hooks(cp.model)
    free = cp.predict(rgb, depth, K_LM, dets)
    for h in hs:
        h.remove()
    flips = []
    for m, a, b in zip(
            [m for m in cp.model.modules() if isinstance(m, Int8Conv)],
            g_in, f_in):
        _, _, amax, t = m.quantized()
        mode = "per_channel" if m.per_channel else "static"
        qa, _ = quantize_act_plain(a.cpu(), mode, amax, t)
        qb, _ = quantize_act_plain(b, mode, amax, t)
        flips.append(int((qa != qb).sum()))
    dR, dt = pose_diff(free)
    print(f"parity: {label}, free-running (each on its own activations): "
          f"max |dR| {dR:.3e}, max |dt|/|t| {dt:.3e}; activations quantized "
          f"differently conv by conv {flips} of {g_in[0].numel()} / "
          f"{g_in[1].numel()} (reported, not gated)")


def run_int8_serving(dev, card, cfg, assets, frames, bf16_pred, profile):
    """Phase 12 (b): lm13 at full width through ``Predictor`` in
    int8-head-static and int8-head (dynamic) beside bf16, in turns, on
    frames that fill the batch of 16, with the launches counted; one pass
    in int8-all per-channel, each of its int8 convs held to the CPU's on
    the card's input; then float32 card against CPU in int8-head-static
    and int8-all per-channel with the card's calibrated scales carried to
    the CPU. Returns the int8 launches of the counted passes."""
    import copy

    import torch

    from rdpn6d_tpu_torch.engine.predictor import Predictor
    from rdpn6d_tpu_torch.models.quant import Int8Conv

    full = make_frames(seed=5, counts=(16,) * INT8_SERVE_FRAMES)
    n_det = sum(len(f[2]) for f in full)
    preds = {"bf16": bf16_pred}
    for name, static in (("int8-head-static", "true"),
                         ("int8-head", "false")):
        c = cfg.apply_opts(['test.int8="head"', f"test.int8_static={static}"])
        preds[name] = physical_z(Predictor(
            c, assets, batch_size=16, dtype=torch.bfloat16, device="cuda",
            allow_random_init=True))
    for pred in preds.values():
        serve(pred, full[:2])   # warm-up at B = 16; static calibrates here
    n8 = 2 * cfg.head.num_layers
    launches = {"int8_conv": 0, "quantize_act": 0}
    rates = {k: [] for k in preds}
    for name in INT8_SERVE_TURNS:
        rate, got = serve_counted(preds[name], full, name,
                                  0 if name == "bf16" else n8)
        if name != "bf16":
            for k in launches:
                launches[k] += got.get(k, 0)
        rates[name].append(rate)
    for name, r in rates.items():
        print(f"serve: lm13 full width {name}: {n_det} poses from "
              f"{len(full)} frames of 16 detections (one batch of 16 a "
              f"frame) a pass, poses/s {' '.join(f'{v:.1f}' for v in r)} "
              f"(median {float(np.median(r)):.1f}; in turns: "
              f"{', '.join(INT8_SERVE_TURNS[:6])}, twice)"
              f"{'' if name == 'bf16' else f'; {n8} int8_conv and {n8} quantize_act launches a batch'}"
              f" [{card}]")
    if profile:
        for name in ("bf16", "int8-head-static"):
            profile_pass(f"served pass at B = 16, {name}",
                         lambda: serve(preds[name], full[:4]))

    # every trunk block's convs too, per-channel scales: the trunk's
    # shapes (stride 2, 1x1 downsample, 64-512 channels) on the path
    c = cfg.apply_opts(['test.int8="all"', 'test.int8_static="per_channel"'])
    p_all = physical_z(Predictor(c, assets, batch_size=16,
                                 dtype=torch.bfloat16, device="cuda",
                                 allow_random_init=True))
    serve(p_all, full[:1])           # calibrates on the first batch
    n_all = sum(isinstance(m, Int8Conv) for m in p_all.model.modules())
    rate, got = serve_counted(p_all, full, "int8-all", n_all)
    for k in launches:
        launches[k] += got.get(k, 0)
    print(f"serve: lm13 full width int8-all per-channel: {n_det} poses, "
          f"{rate:.1f} poses/s; {n_all} int8 convs a batch (trunk and "
          f"head), launches {got} [{card}]")
    # that model's int8 convs on phase 3's first frame, each against a CPU
    # copy of the module (plain versions) on the card's input to it
    g_in, g_out, hs = int8_hooks(p_all.model)
    rgb, depth, dets = frames[0]
    p_all.predict(rgb, depth, K_LM, dets)
    for h in hs:
        h.remove()
    convs = [m for m in p_all.model.modules() if isinstance(m, Int8Conv)]
    check(len(g_in) == len(g_out) == n_all,
          f"int8-all: {len(g_in)} int8 conv calls, want {n_all}")
    with torch.no_grad():
        for i, (m, x, y) in enumerate(zip(convs, g_in, g_out)):
            ref = copy.deepcopy(m).cpu()(x.cpu())
            check(torch.equal(y.cpu(), ref), f"int8-all bf16 pass: int8 "
                  f"conv {i} differs from its CPU copy on the card's input")
    print(f"parity: int8-all per-channel bf16 served batch of {len(dets)}: "
          f"all {n_all} int8 conv outputs bit-equal to the CPU's (plain "
          f"versions) on the card's inputs [{card}]")

    int8_card_vs_cpu(cfg, assets, frames[0], card,
                     ['test.int8="head"', "test.int8_static=true"], True)
    int8_card_vs_cpu(cfg, assets, frames[0], card,
                     ['test.int8="all"', 'test.int8_static="per_channel"'],
                     False)
    return launches


def run_int8_eval(dev, card, work, bf16_mean):
    """Phase 12 (c): ``main --eval-only`` on phase 9's tree and checkpoint
    with ``test.int8="head" test.int8_static=true``; returns its int8
    launches."""
    import torch

    from rdpn6d_tpu_torch import main as port_main
    from rdpn6d_tpu_torch.ops import cuda_build

    out = os.path.join(work, "out_int8")
    os.makedirs(out)
    os.symlink(os.path.join(work, "out", "ckpt"), os.path.join(out, "ckpt"))
    n_rois = 13 * EVAL_FRAMES_PER_OBJ
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    res = port_main.main([
        "--config-file",
        os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "lm13.py"),
        "--eval-only", "--opts", f'train.output_dir="{out}"',
        'test.int8="head"', "test.int8_static=true"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(cuda_build.LAUNCHES)
    res = res["lm_13_test"]
    want = 6 * -(-n_rois // 32)      # 6 head convs a batch of 32
    check(got.get("int8_conv", 0) == want
          and got.get("quantize_act", 0) == want
          and got.get("min_dist2", 0) == 13,
          f"int8 eval launches {got}, want int8_conv and quantize_act "
          f"{want}, min_dist2 13")
    ident, R, t = read_csv(os.path.join(out, "lm_13_test_bop19.csv"))
    check(len(ident) == n_rois and bool(np.isfinite(R).all()
                                        and np.isfinite(t).all()),
          "int8 eval: missing or non-finite poses in the CSV")
    log = open(os.path.join(out, "log.txt")).read()
    check("int8 static scales calibrated" in log,
          "int8 eval: no calibration on the first batch")
    st = res["stats"]
    keys = [k for k in ("ad_2", "ad_5", "ad_10", "adi_10", "re_5", "te_5",
                        "proj_5") if k in res["mean"]]
    table = ", ".join(f"{k} {res['mean'][k]:.2f} (bf16 {bf16_mean[k]:.2f})"
                      for k in keys)
    print(f"eval: lm13 full width int8-head-static main --eval-only on "
          f"lm_13_test: {st['n_rois']} ROIs, "
          f"{st['n_timed'] / st['wall_s']:.1f} poses/s past warm-up, split "
          f"wall time {wall:.2f} s; MEAN {table} (seeded weights: "
          f"reported, not gated); launches {got} [{card}]")
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one served pass and one train step "
                         "with torch.profiler and print the device time by "
                         "kernel, and time phase 10's loop on held batches")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "rdpn6d_tpu_torch")):
        print("chip_smoke: rdpn6d_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    from rdpn6d_tpu_torch.configs import lm13
    from rdpn6d_tpu_torch.engine.predictor import Predictor
    from rdpn6d_tpu_torch.evaluation import pose_error as pe
    from rdpn6d_tpu_torch.ops import cuda_build
    from rdpn6d_tpu_torch.ops.min_dist import min_dist2, min_dist2_plain

    card = nvidia_smi("name,power.limit")
    print(f"card: {card}; max SM clock {nvidia_smi('clocks.max.sm')}")
    dev = torch.device("cuda")

    # 1. build --------------------------------------------------------------
    kernels = ["min_dist2", "region_label", "int8_conv"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; from rdpn6d_tpu_torch.ops "
         f"import cuda_build; cuda_build.build({k!r})"], cwd=ROOT)
        for k in kernels]
    for k, p in zip(kernels, procs):
        check(p.wait(timeout=900) == 0, f"build of {k} failed")
    for k in kernels:
        _, built = cuda_build.load(k)
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build: {k} -> {os.path.relpath(built.path, ROOT)}; "
              + " | ".join(ptxas))
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(kernels)} "
          "kernel(s)")

    # 2. kernel vs plain ------------------------------------------------------
    gen = torch.Generator(device="cpu").manual_seed(0)
    errs = {}
    # ragged around a block's 1024 a-rows, the 256-row stage chunk and the
    # 4-row step; (1, 300, 5001) and (1, 300, 700) split b over blocks
    for (B, n, m, d) in [(1, 7, 5, 3), (1, 300, 700, 3), (2, 100, 129, 5),
                         (1, 1023, 255, 3), (2, 1025, 257, 3),
                         (3, 2049, 513, 3), (1, 300, 5001, 3),
                         (16, 4096, 4096, 3)]:
        a = (torch.randn(B, n, d, generator=gen) * 0.05
             + torch.tensor([0.0, 0.0, 1.0] + [0.0] * (d - 3))).to(dev)
        b = (torch.randn(B, m, d, generator=gen) * 0.05
             + torch.tensor([0.0, 0.0, 1.0] + [0.0] * (d - 3))).to(dev)
        out = min_dist2(a, b)
        ref = min_dist2_plain(a, b)
        torch.cuda.synchronize()
        scale = float((a * a).sum(-1).max() + (b * b).sum(-1).max())
        err = float((out - ref).abs().max())
        # both run the direct form in float32; they differ only by FMA
        # contraction, a few ulps of the largest squared norm
        tol = 1e-6 * scale
        print(f"kernel: min_dist2 B={B} N={n} M={m} D={d} "
              f"({min_dist2_plan(a, b)}) max_abs_err {err:.3e} "
              f"(tol {tol:.3e})")
        check(err <= tol, f"min_dist2 disagrees with plain at {B}x{n}x{m}")
        errs[(B, n, m, d)] = err
    # a NaN in one b-row of one ROI makes that ROI's every row NaN, as the
    # plain version (and jnp.min) does, split or not; nothing leaks
    for shape in ((2, 300, 700), (600, 33, 130)):
        x = torch.randn(*shape[:2], 3, generator=gen).to(dev)
        y = torch.randn(shape[0], shape[2], 3, generator=gen)
        y[-1, shape[2] // 2, 1] = float("nan")
        y = y.to(dev)
        out, ref = min_dist2(x, y), min_dist2_plain(x, y)
        torch.cuda.synchronize()
        check(torch.equal(out.isnan(), ref.isnan())
              and bool(ref[-1].isnan().all())
              and not bool(ref[:-1].isnan().any()),
              f"min_dist2 NaN pattern differs from plain at {shape}")
        print(f"kernel: min_dist2 B={shape[0]} N={shape[1]} M={shape[2]} "
              f"({min_dist2_plan(x, y)}) NaN in one b-row: NaN rows equal "
              "the plain version's")
    B, N, M = 16, 4096, 4096
    ms = cuda_ms(lambda: min_dist2(a, b), iters=50)
    dev_ms = queued_ms(lambda: min_dist2(a, b), iters=50)
    plain_ms = cuda_ms(lambda: min_dist2_plain(a, b), iters=5, warmup=1)
    lib_ms = cuda_ms(lambda: torch.cdist(a, b).square().amin(-1), iters=10)
    bound_ms, bound_by = min_dist2_bound(B, N, M)
    print(f"kernel: min_dist2 16x4096x4096 ({min_dist2_plan(a, b)}) kernel "
          f"{ms:.4f} ms by CUDA events, {100 * bound_ms / ms:.1f}% of bound "
          f"({dev_ms:.4f} ms device time), plain {plain_ms:.4f} ms, cdist "
          f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    label_err, label_times = check_region_label(dev, card)
    gt_err, gt_times = check_gt_labels(dev, card)
    surface_err, surface_times = check_surface_labels(dev, card)

    # 3. serve ----------------------------------------------------------------
    cfg = lm13.get_config().apply_opts(['head.init="fan_in"'])
    assets = lm_assets(cfg.head.num_regions, 4096, seed=1)
    frames = make_frames(seed=2)
    n_det = sum(len(f[2]) for f in frames)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    preds = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        preds[name] = physical_z(Predictor(
            cfg, assets, batch_size=16, dtype=dt, device="cuda",
            allow_random_init=True))
        serve(preds[name], frames)    # warm-up: cuDNN plans per batch size
    cuda_build.reset_launches()
    served = {}
    for name in ("bf16", "f32"):
        outs, secs = serve(preds[name], frames)
        flat = [r for o in outs for r in o]
        check(len(flat) == n_det, f"{name}: {len(flat)} poses for "
              f"{n_det} detections")
        R = np.stack([r["R"] for r in flat])
        t = np.stack([r["t"] for r in flat])
        check(R.shape == (n_det, 3, 3) and t.shape == (n_det, 3),
              f"{name}: pose shapes {R.shape} {t.shape}")
        check(bool(np.isfinite(R).all() and np.isfinite(t).all()),
              f"{name}: non-finite poses")
        served[name] = (flat, R, t)
        print(f"serve: lm13 full width {name}: {n_det} poses from "
              f"{len(frames)} frames in {secs * 1e3:.1f} ms = "
              f"{n_det / secs:.1f} poses/s [{card}]")

    if args.profile:
        profile_pass("served pass, bf16",
                     lambda: serve(preds["bf16"], frames))

    # 4. score ----------------------------------------------------------------
    flat, R_est, t_est = served["f32"]
    rng = np.random.RandomState(3)
    q, _ = np.linalg.qr(rng.randn(n_det, 3, 3))
    R_gt = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    t_gt = np.concatenate([rng.uniform(-0.15, 0.15, (n_det, 2)),
                           rng.uniform(0.6, 1.2, (n_det, 1))], 1)
    pts = np.stack([assets.for_obj(r["obj_id"])["points"] for r in flat])
    host = [R_est, t_est.astype(np.float32), R_gt, t_gt.astype(np.float32),
            pts, np.broadcast_to(K_LM, (n_det, 3, 3)).copy()]
    on_card = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
               for x in host]
    scores = {
        "add": pe.add(*on_card[:5]), "adi": pe.adi(*on_card[:5]),
        "re": pe.re_deg(on_card[0], on_card[2]),
        "te": pe.te(on_card[1], on_card[3]), "proj": pe.proj_2d(*on_card)}
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    check(launches.get("min_dist2", 0) > 0,
          "min_dist2 was not launched on the served + scored path")
    on_cpu = [torch.from_numpy(np.ascontiguousarray(x)) for x in host]
    adi_cpu = pe.adi(*on_cpu[:5])
    adi_err = float((scores["adi"].cpu() - adi_cpu).abs().max())
    # the card's kernel and the CPU's plain version differ by FMA rounding
    # of squared distances ~0.1 m^2: well under 1e-6 m after the sqrt
    check(adi_err <= 1e-6, f"adi card vs CPU differs by {adi_err:.3e} m")
    for k, v in scores.items():
        v = v.cpu().numpy()
        check(v.shape == (n_det,) and bool(np.isfinite(v).all()),
              f"score {k}: shape {v.shape} or non-finite")
        print(f"score: {k} mean {v.mean():.6f} over {n_det} poses")
    print(f"score: adi card vs CPU max diff {adi_err:.3e} m; launches "
          f"{launches}")

    # 5. card vs CPU ------------------------------------------------------------
    cpu_pred = physical_z(Predictor(
        cfg, assets, batch_size=16, dtype=torch.float32, device="cpu",
        allow_random_init=True))
    rgb, depth, dets = frames[0]
    cpu_out = cpu_pred.predict(rgb, depth, K_LM, dets)
    gpu_out = preds["f32"].predict(rgb, depth, K_LM, dets)
    dR = max(float(np.abs(a["R"] - b["R"]).max())
             for a, b in zip(gpu_out, cpu_out))
    dt_rel = max(float(np.abs(a["t"] - b["t"]).max()
                       / np.abs(b["t"]).max()) for a, b in zip(gpu_out,
                                                              cpu_out))
    print(f"parity: f32 card vs CPU over {len(dets)} ROIs: max |dR| "
          f"{dR:.3e}, max |dt|/|t| {dt_rel:.3e}")
    # float32 on both (TF32 off); cuDNN and oneDNN sum in other orders
    # through ~40 layers, and a region argmax near-tie may flip a pixel
    check(dR <= 1e-3 and dt_rel <= 1e-3, "card and CPU poses disagree")

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # 6. train -------------------------------------------------------
        train_launches = run_train(dev, card, args.profile, work)

        # 7. train parity ------------------------------------------------
        train_parity(dev, work)

        # 8. labels, card vs CPU -----------------------------------------
        label_launches = labels_card_vs_cpu(dev, card, work)

        # 9. eval --------------------------------------------------------
        eval_launches, bf16_mean = run_eval_phase(dev, card, work)

        # 10. train from disk --------------------------------------------
        disk_launches = run_train_from_disk(dev, card, work, args.profile)

        # 11. train lmo from disk ----------------------------------------
        lmo_launches = run_train_lmo(dev, card, work)

        # 12. int8 serving -----------------------------------------------
        int8_err, quant_err, int8_times, quant_times = check_int8(dev, card)
        serve8 = run_int8_serving(dev, card, cfg, assets, frames,
                                  preds["bf16"], args.profile)
        eval8 = run_int8_eval(dev, card, work, bf16_mean)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    result = {"kernels": [{
        "name": "min_dist2", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/min_dist2.cu",
        "replaces": "rdpn6d_tpu/ops/pallas_kernels.py:57",
        "launches": launches.get("min_dist2", 0) + eval_launches
        + disk_launches.get("min_dist2", 0)
        + lmo_launches.get("min_dist2", 0),
        "max_abs_err": max(errs.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms}, {
        "name": "region_label", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/region_label.cu",
        "replaces": "rdpn6d_tpu/ops/region.py:21",
        "launches": label_launches["region_label"]
        + disk_launches.get("region_label", 0)
        + lmo_launches.get("region_label", 0),
        "max_abs_err": label_err, **label_times}, {
        "name": "gt_labels", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/region_label.cu",
        "replaces": "rdpn6d_tpu/data/pipeline.py:197",
        "launches": train_launches.get("gt_labels", 0)
        + disk_launches.get("gt_labels", 0)
        + lmo_launches.get("gt_labels", 0),
        "max_abs_err": gt_err, **gt_times}, {
        "name": "surface_labels", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/region_label.cu",
        "replaces": "rdpn6d_tpu/data/pipeline.py:222",
        "launches": label_launches["surface_labels"]
        + disk_launches.get("surface_labels", 0)
        + lmo_launches.get("surface_labels", 0),
        "max_abs_err": surface_err, **surface_times}, {
        "name": "int8_conv", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/int8_conv.cu",
        "replaces": "rdpn6d_tpu/models/quant.py:42",
        "launches": serve8["int8_conv"] + eval8.get("int8_conv", 0),
        "max_abs_err": int8_err, **int8_times}, {
        "name": "quantize_act", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/int8_conv.cu",
        "replaces": "rdpn6d_tpu/models/quant.py:32",
        "launches": serve8["quantize_act"] + eval8.get("quantize_act", 0),
        "max_abs_err": quant_err, **quant_times}], "card": card}
    print(card)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
