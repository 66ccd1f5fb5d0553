#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rdpn6d_tpu_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, serves and trains on the
card.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure:
  1. build  — every CUDA kernel of the paths, from ``rdpn6d_tpu_torch/csrc``
              with nvcc for sm_90a (in parallel, one nvcc per source), and
              beside them VSD's host rasterizer with the host compiler;
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
              version's; ``roi_crop`` (the network inputs of a ROI batch)
              at B = 1, 16 and 24 of 1 and 8 480x640 frames, uint8 and
              float32 RGB, depth in metres (a NaN pixel) and raw with a
              factor, windows across every edge, off the frame, of scale 1
              and max(H, W) and on half pixels, normalised and not, 256/64
              and 128/32, bit-equal to its plain version, then timed at
              the served batch beside its plain version, ``F.grid_sample``
              and its bound, and checked and timed beside its bound at an
              eval batch (32 ROIs of 8 frames) and the train shape (24
              ROIs of 8 frames, ``normalize=False``), both of raw depth;
  3. serve  — the lm13 configuration at full width (ResNet-34, 256² ROIs,
              64² head maps, 32 regions, rot_concat), seeded random
              weights, through ``Predictor.predict``: 3 distinct 480x640
              RGB-D frames with 5, 6 and 5 detections, in bf16 and float32,
              one ``roi_crop`` launch a served batch;
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
              outputs bit-equal, a NaN as the plain version has it; the
              fused ``bn_relu_quantize`` (BN + ReLU + concat + quantize)
              against its plain version in every mode, bf16 and f32, at
              the head's 256 and 256 + 64 skip channels, 512 at 8x8,
              channels not a multiple of 32, H W not a multiple of 8 or of
              the pixel tile, B = 1 and with a NaN in y and in the skip
              (xq and sx bit-equal), then timed at the head's shapes beside
              its bound, its plain version and the unfused BN, ReLU,
              ``torch.cat`` and ``quantize_act``; (b)
              lm13 at full width through ``Predictor`` in
              int8-head-static and int8-head (dynamic) beside bf16, on 16
              frames of 16 detections (256 poses, one batch of 16 a
              frame), each mode in turns, 4 passes each: poses/s, 6
              ``int8_conv`` and 6 ``bn_relu_quantize`` launches (no
              ``quantize_act``) a served batch; the head's device time a
              batch of 16 (queued and profiler) and its kernel launches,
              folded against the same head run op by op (at least 13
              launches fewer) and bf16's head;
              one pass in int8-all with per-channel scales (every trunk
              block's convs too: 41 int8 convs a batch, the head's 6 with
              the BN before them folded), each of its int8
              convs bit-equal to a CPU copy of the module on the card's
              input; float32 int8-head-static and int8-all per-channel card
              vs CPU with the card's calibrated scales carried to the CPU
              (through the flax quant tree) and each int8 conv's input too
              (a folded conv's BN input and skip): every int8 conv's output
              bit-equal, poses within 1e-3; the
              free-running difference of int8-head-static and the
              activations quantized differently conv by conv printed;
              (c) ``main --eval-only`` with ``test.int8="head"
              test.int8_static=true`` on phase 9's tree and checkpoint:
              launches (6 ``int8_conv`` and 6 ``bn_relu_quantize`` a batch,
              ``min_dist2`` one an
              object), calibration on the first batch, the MEAN table
              beside phase 9's bf16 one (reported: seeded weights), split
              wall time; (d) ``int8_conv``'s time at the head shapes by CUDA
              events, ``queued_ms`` and the profiler, beside its bound, the
              plain version, cuDNN's bf16 ``F.conv2d`` and
              ``torch._int_mm`` over ``F.unfold`` (checked equal to the
              kernel's output), and ``quantize_act``'s beside its bound;
              the conv kernel's registers, spills and shared memory from
              the build log, and its launch plan at the head.
 13. data parallelism — (a) two ranks of one process group over gloo
              on the one card (NCCL refuses two ranks of one device),
              spawned by ``parallel.spawn``: lm13 at full width, f32 with
              TF32 off, 24 global ROIs (12 a rank, the ROIs of 4 of each
              batch's 8 frames), card-resident raw batches preprocessed
              (``train=True``, no DZI jitter) on each rank, 3 steps of
              ``make_sharded_train_step`` against one process taking
              ``make_train_step`` on the global batch on the same card:
              every loss, ``grad_norm``, parameter and BatchNorm statistic
              within the tolerances of ``run_dist_ranks`` (phase 7's kind),
              the ranks bit-equal, each rank's own ``roi_crop`` (one a
              preprocessed batch) and ``gt_labels`` (one a step) launches
              counted in its process and sent back; then 3 bf16 steps
              timed on each side (two ranks time-share one card: not a
              scaling number) and the gradient all-reduce's ms; (b)
              ``main --multihost --num-processes 1 --process-id 0`` over
              NCCL, a group of one whose collectives run, on phase 10's
              trees: one epoch, a checkpoint, eval of ``lm_13_test``
              during training (the predictions gathered over NCCL,
              ``min_dist2`` on rank 0), then ``--resume`` to a second.
 14. the other configs and VSD — (a) ``main`` on ``configs/ycbv.py`` at
              full width (21 classes, the symmetric PM loss, the visib20
              filter, TRAIN2 0.5, the trunk from phase 10's .pth) over a
              ycbv tree written here (12 real PNG frames of 8 cubes with GT
              xyz crops and a mostly hidden ninth, 6 PBR JPEG frames, 4
              test frames, ``image_sets/keyframe.txt``): the filtered
              record count equal to the tree's instances at visib_fract >=
              0.2 (and fewer than all), 8 iterations, eval on the 3
              keyframes, the AUCadd, AUCadi, AUCad, ad and ABSad columns
              finite, ``gt_labels`` once a real iteration,
              ``surface_labels`` once a PBR one, ``min_dist2`` once an
              object; (b) ``roi_crop`` (train and eval shapes) and
              ``surface_labels`` bit-equal to their plain versions at
              T-LESS's 540x720 frames, ``gt_labels`` as phase 2 holds it,
              then ``main`` on ``configs/tless.py`` (30 classes) for 4
              iterations and its eval: every preprocessed frame 540x720,
              the device cache's bytes those of 540x720 frames, the MSPD
              thresholds scaled to width 720, AR_mssd, AR_mspd and AR
              reported and equal to the AR recomputed on the host from the
              written CSV and the tree; (c) ``main --eval-only`` on
              ``configs/mini.py`` over a mini tree (meshes with faces) with
              a seeded checkpoint: AR_vsd in [0, 1], AR the mean of three,
              each pose rendered once on the host (the render cache's
              misses, every target's GT pose among them), the VSD host
              seconds and ms a render.
 15. MP6D, ITODD and the flat path — (a) ``main`` on ``configs/mp6d.py``
              at full width (20 classes, the "code" colour aug,
              background replacement with truncation) one epoch over a
              ``ycb_style`` tree written here (6 train and 3 test frames
              of 8 cubes: ``-color``/``-depth``/``-label`` PNGs and
              ``-meta.mat``; no xyz crops, so ``surface_labels`` once an
              iteration), then ``main --eval-only`` on ``mp6d_test``
              (AUCadd, AUCadi, AUCad asked with VSD; ``min_dist2`` once
              an object); (b) ``roi_crop``, ``surface_labels`` and
              ``gt_labels`` against their plain versions at ITODD's
              960x1280 frames, as phase 14(b) holds them at 540x720, the
              host decode ms of a 960x1280 gray TIFF, JPEG and PNG frame,
              then ``main`` on ``configs/itodd.py`` (28 classes) one
              epoch of PBR frames (scenes 0 and 49) and its eval of the
              val scene read from gray TIFFs: every preprocessed frame
              960x1280, the device cache's bytes a frame; (c) lm13 with
              ``data.grouped_train=false``: the flat path's preprocessing
              of 4 samples card vs CPU (crops bit-equal, masks equal) and
              phase 7's step on each side's batch to phase 7's bounds,
              ``gt_labels`` on a 24-sample flat batch's float32 visib,
              trunc and xyz planes against its plain version and timed,
              ``main`` one epoch from the flat loader (``gt_labels`` and
              ``roi_crop`` once an iteration, no device cache), ``main
              --eval-only --debug`` on its checkpoint (the masked coord L1
              of lm_ape_test's 8 instances), and ``Predictor(ckpt_dir=...)``
              serving phase 3's frames from that checkpoint: its weights
              the trained model's, its poses (z moved to ~1 m, as phase 3
              does) within phase 5's bounds of the trained model's.
 16. RANSAC-Kabsch and the model variants — (a) ``ransac_kabsch``
              (``csrc/ransac_kabsch.cu``) against its plain version on the
              card at (B, N) = (1, 4096), (8, 4096), (16, 4096), (32,
              4096), (64, 4096), (3, 100) and (2, 4097) (every cluster size
              of the served and eval batches), 128 hypotheses of 4:
              correspondences of a known pose with 0%, 30% and 60%
              outliers, a ROI with no valid point, one with 3 and one with
              a NaN point; where the best hypothesis agrees the score and ratio equal and R, t within 1e-4 (a ROI
              with no valid point: both R rotations, t equal), where it
              does not the scores within 1 and the fits within 1e-2; NaN
              patterns equal; then timed by ``queued_ms`` at 6, 16 (the
              served batch, also by CUDA events and beside the plain
              version) and 32 ROIs of 4096 points, each beside its bound
              and the blocks of a ROI's cluster and the SMs they cover,
              with registers and spills from the build log; (b) lm13
              at full width with ``test.use_pnp=true`` through ``Predictor``
              in bf16 and f32 on phase 3's frames: one ``ransac_kabsch``
              launch a served batch, finite poses, the ROIs refined (ratio >
              0.05) counted; the f32 pass's fits against the plain version
              on the same inputs, and frame 0 card vs CPU (the same weights
              and draws): the pre-fallback R within phase 5's 1e-3 where the
              valid masks and the best hypothesis agree; (c) ``main
              --eval-only`` with ``test.use_pnp=true`` on phase 9's tree and
              checkpoint: one ``ransac_kabsch`` launch an eval batch,
              ``min_dist2`` one an object, the fits' NaN patterns equal
              to the plain version's on the same inputs and their
              agreement reported, the MEAN table beside phase 9's;
              (d) the space-to-depth stem, ``pnp.r_only`` (TransHead),
              ``SimplePointPnP`` and ``PointPnP`` at lm13 full width: the f32
              forward of 4 ROIs card vs CPU within phase 5's bounds, and
              phase 7's f32 train step card vs CPU.
Kernel launch counts are zeroed right before each path (phases 3-4, phase
6, each run of phase 8, phase 9's ``main``, each of phase 10's and phase
11's ``main``, each int8 served pass and the int8 ``main`` of phase 12,
each rank's steps and each ``main`` of phases 13, 14 and 15, phase 15's
served pass, and phase 16's served passes and ``main``) and read right
after it. In phases 3, 6, 9, 10, 11, 12(c), 13, 14, 15 and 16(b, c) the
batches the entry points preprocess are counted too
(``PreprocessCalls``), and ``roi_crop`` must have launched once for each.
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
# roi_crop: per input-crop pixel 6 float32 out, per coordinate pixel 5;
# per source pixel its taps reach, its RGB and depth in once; ~96 float32
# operations an input-crop pixel (4 planes of 4 taps weighted and blended,
# the normalisation, the back-projection; a division counted as one)
ROI_CROP_OPS_PER_PIXEL = 96
SERVE_BATCH = 16             # the Predictor's batch of phases 3 and 12
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
BOP_INSTS = 8                # cubes a frame of phase 14's trees
YCBV_TRAIN_FRAMES = 12       # x 8 cubes (and a hidden ninth under 20%
YCBV_EPOCHS = 2              # visible): 96 records, 4 iterations an epoch
YCBV_PBR_FRAMES = 6          # one train_pbr scene, JPEG
YCBV_TEST_FRAMES = 4         # 3 keyframes
TLESS_TRAIN_FRAMES = 6       # 48 records: 2 iterations an epoch, 2 epochs
TLESS_TEST_FRAMES = 3
MINI_TEST_FRAMES = 8


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


def same_bits(a, b) -> bool:
    """Equal values, NaN where the other has NaN."""
    import torch

    nan = a.isnan()
    return bool(torch.equal(nan, b.isnan())) and bool(
        torch.equal(a.masked_fill(nan, 0), b.masked_fill(nan, 0)))


def roi_crop_inputs(B, F, H, W, seed, dev, rgb_dtype, raw, S):
    """``roi_crop``'s frame and window arguments: F frames (a smooth colour
    field with noise, uint8 or float32; a depth surface of 0.6-1.1 m with
    5% holes, as float32 metres with one NaN pixel, or int32 raw units with
    a factor of 1000 or 10000 a frame), LineMOD's K scaled to the frame,
    each ROI's frame drawn at random, a window near the frame with a side
    0.1-1.3x max(H, W) clamped to [1, max(H, W)]; then, as far as B
    reaches, ROI 0 across the top-left corner, 1 across the bottom-right,
    2 wholly off the frame, 3 of scale 1, 4 of scale max(H, W), 5 with its
    taps on exact half pixels (an integer centre and a step of 0.75)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    phase = torch.rand(F, 1, 1, 3, generator=g) * 6.28
    rgb = 127.5 + 100 * torch.sin(
        xx[None, ..., None] / torch.tensor([40.0, 49.0, 58.0])
        + yy[None, ..., None] / 55 + phase) \
        + 8 * torch.randn(F, H, W, 3, generator=g)
    rgb = rgb.clamp(0, 255)
    if rgb_dtype == "uint8":
        rgb = rgb.to(torch.uint8)
    depth = (0.6 + 0.4 * torch.rand(F, 1, 1, generator=g)
             + 0.1 * torch.sin(xx / 70) * torch.cos(yy / 90)) \
        * (torch.rand(F, H, W, generator=g) > 0.05)
    factor = None
    if raw:
        factor = torch.tensor([1000.0, 10000.0] * F)[:F]
        depth = torch.round(depth * factor[:, None, None]).to(torch.int32)
    else:
        depth[0, H // 2, W // 2] = float("nan")
    f = float(K_LM[0, 0]) * W / 640
    K = torch.tensor([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]]) \
        .repeat(F, 1, 1)
    K[:, :2, 2] += torch.rand(F, 2, generator=g) - 0.5
    frame_idx = torch.randint(0, F, (B,), generator=g)
    side = float(max(H, W))
    center = torch.rand(B, 2, generator=g) * torch.tensor([1.2 * W, 1.2 * H]) \
        - torch.tensor([0.1 * W, 0.1 * H])
    scale = ((torch.rand(B, generator=g) * 1.2 + 0.1) * side).clamp(1, side)
    edges = [((0.0, 0.0), 0.3 * side), ((W - 1.0, H - 1.0), 0.5 * side),
             ((-side, -side), 0.4 * side), ((W / 3, H / 3), 1.0),
             ((W / 2, H / 2), side), ((float(W // 2), float(H // 2)),
                                      0.75 * S)]
    for b, ((cx, cy), sd) in enumerate(edges[:B]):
        center[b] = torch.tensor([cx, cy])
        scale[b] = sd
    return [None if t is None else t.contiguous().to(dev)
            for t in (rgb, depth, factor, K, frame_idx, center, scale)]


def roi_crop_bound(rgb, depth, frame_idx, center, scale, S, O
                   ) -> tuple[float, str]:
    """Least ms the card could take for ``roi_crop`` on these inputs: the
    outputs written once, B (S² 6 + O² 5) float32; each source pixel that
    this call's bilinear taps reach read once (its RGB and its depth), the
    coordinate axes, K, the factors and each ROI's scalars; against
    ROI_CROP_OPS_PER_PIXEL operations an input-crop pixel. The larger,
    and which it is."""
    F, H, W = depth.shape
    B = frame_idx.shape[0]
    hit = np.zeros((F, H, W), bool)
    c, sc = center.cpu().numpy(), scale.cpu().numpy()
    fi = frame_idx.cpu().numpy()
    grid = np.arange(S, dtype=np.float32) - np.float32(S / 2)
    for b in range(B):
        step = sc[b] / np.float32(S)
        taps = []
        for axis, n in ((1, H), (0, W)):
            x0 = np.floor(c[b, axis] + grid * step).astype(np.int64)
            k = np.unique(np.concatenate([x0, x0 + 1]))
            taps.append(k[(k >= 0) & (k < n)])
        hit[fi[b]][np.ix_(*taps)] = True
    per_px = 3 * rgb.element_size() + depth.element_size()
    in_bytes = int(hit.sum()) * per_px + (H + W) * 4 + F * (9 + 1) * 4 \
        + B * (8 + 3 * 4)
    out_bytes = B * (S * S * 6 + O * O * 5) * 4
    bytes_s = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    ops_s = B * S * S * ROI_CROP_OPS_PER_PIXEL / FP32_INSTR_PER_S
    return 1e3 * max(ops_s, bytes_s), \
        "operations" if ops_s >= bytes_s else "bytes"


def library_roi_crop(rgb, depth, frame_idx, center, scale, S):
    """The yardstick, crop only (no normalisation, back-projection or
    coordinate map): ``F.grid_sample`` (bilinear, zero padding,
    align_corners=True) of the RGB and depth planes of each ROI's frame,
    [B,4,H,W] float32, at the S grid's source coordinates. Its inputs are
    made here, outside the call it returns; timed only, the port never
    calls it."""
    import torch
    import torch.nn.functional as fn

    from rdpn6d_tpu_torch.ops.warp import _src_coords

    H, W = depth.shape[1], depth.shape[2]
    planes = torch.cat([rgb.float(), depth.float()[..., None]], -1)[
        frame_idx].permute(0, 3, 1, 2).contiguous()
    sx, sy = _src_coords(center, scale, S)
    B = frame_idx.shape[0]
    grid = torch.stack([(sx * (2.0 / (W - 1)) - 1)[:, None, :].expand(B, S, S),
                        (sy * (2.0 / (H - 1)) - 1)[:, :, None].expand(B, S, S)],
                       -1).contiguous()
    return lambda: fn.grid_sample(planes, grid, mode="bilinear",
                                  padding_mode="zeros", align_corners=True)


# The shapes roi_crop is timed at (phase 2, time_crop.py), lm13's 256 / 64:
# name -> (what, ROIs a frame, frames, raw depth, normalize, seed)
ROI_CROP_SHAPES = {
    "served": (f"served batch, {SERVE_BATCH} ROIs of one 480x640 frame, "
               "uint8 RGB, depth in metres", SERVE_BATCH, 1, False, True, 21),
    "eval": ("eval batch, 32 ROIs of 8 480x640 frames, uint8 RGB, raw "
             "int32 depth", 4, 8, True, True, 31),
    "train": (f"train shape, {TRAIN_ROIS} ROIs of 8 480x640 frames, uint8 "
              "RGB, raw int32 depth, normalize=False", TRAIN_ROIS // 8, 8,
              True, False, 41),
}


def roi_crop_shape(name, dev):
    """``roi_crop``'s tensor arguments at one of ROI_CROP_SHAPES, on
    ``dev``: ``make_frames``' frames and detection boxes, each box's
    test-time window (``dzi_jitter`` at lm13's pad scale), LineMOD's K; raw
    depth is the frame's metres in int32 millimetres with a factor of
    1000, as LM's PNGs hold it. Returns (what, args, normalize)."""
    import torch

    from rdpn6d_tpu_torch.configs import lm13
    from rdpn6d_tpu_torch.data.pipeline import dzi_jitter

    what, per_frame, n_frames, raw, normalize, seed = ROI_CROP_SHAPES[name]
    frames = make_frames(seed=seed, counts=(per_frame,) * n_frames)
    bbox = torch.from_numpy(np.stack([x.bbox_xyxy for f in frames
                                      for x in f[2]]))
    center, scale = dzi_jitter(bbox, (480, 640),
                               pad_scale=lm13.get_config().data.dzi_pad_scale)
    depth = torch.from_numpy(np.stack([f[1] for f in frames]))
    factor = None
    if raw:
        factor = torch.full((n_frames,), 1000.0)
        depth = torch.round(depth * 1000.0).to(torch.int32)
    args = [torch.from_numpy(np.stack([f[0] for f in frames])), depth,
            factor, torch.from_numpy(K_LM)[None].repeat(n_frames, 1, 1),
            torch.arange(n_frames).repeat_interleave(per_frame), center,
            scale]
    return what, [None if t is None else t.contiguous().to(dev)
                  for t in args], normalize


def check_roi_crop(dev, card):
    """Phase 2 for ``roi_crop``: the kernel against its plain version at
    B = 1, 16 and 24, F = 1 and 8 frames with mixed frame indices, uint8
    and float32 RGB, float32 depth (a NaN pixel) and int32 raw depth with a
    factor, windows across every edge, wholly off the frame, of scale 1 and
    max(H, W) and on exact half pixels, normalised and not, at 256 / 64 and
    128 / 32; the RGB and the coordinate map bit-equal (NaN where the plain
    version has NaN), xyz within 1e-5 of its largest value (the design
    gives it bit for bit: 0 is expected). Then times the served batch (16
    ROIs of one 480x640 frame, uint8 RGB, depth in metres, lm13's boxes)
    beside the plain version, ``F.grid_sample`` and the bound, and the eval
    batch and train shape of ROI_CROP_SHAPES (raw depth), each checked
    bit for bit and timed beside its bound. Returns (the largest xyz
    difference, times)."""
    import torch

    from rdpn6d_tpu_torch.configs import lm13
    from rdpn6d_tpu_torch.ops.roi_crop import roi_crop, roi_crop_plain

    cfg = lm13.get_config()
    d = cfg.data
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    worst = 0.0
    for (B, F, rgb_dtype, raw, S, O) in [
            (1, 1, "uint8", False, 256, 64), (16, 1, "uint8", False, 256, 64),
            (16, 1, "uint8", True, 256, 64), (24, 8, "uint8", True, 256, 64),
            (24, 8, "float32", False, 256, 64),
            (16, 8, "float32", True, 128, 32)]:
        inp = roi_crop_inputs(B, F, 480, 640, B + F + S, dev, rgb_dtype, raw,
                              S)
        for normalize in (True, False):
            got = roi_crop(*inp, S, O, mean, std, normalize=normalize)
            ref = roi_crop_plain(*inp, S, O, mean, std, normalize=normalize)
            torch.cuda.synchronize()
            what = (f"B={B} F={F} {rgb_dtype} RGB, "
                    f"{'raw' if raw else 'metre'} depth, {S}/{O}, "
                    f"normalize={normalize}")
            check(same_bits(got[0][..., :3], ref[0][..., :3])
                  and same_bits(got[1][..., 3:], ref[1][..., 3:]),
                  f"roi_crop RGB or coordinate map differs at {what}")
            xyz = [(got[0][..., 3:], ref[0][..., 3:]),
                   (got[1][..., :3], ref[1][..., :3])]
            check(all(bool(torch.equal(a.isnan(), r.isnan())) for a, r in xyz),
                  f"roi_crop xyz NaN pattern differs at {what}")
            errs = [float((a - r).nan_to_num(0).abs().amax(dim=(0, 1, 2))
                          .max()) for a, r in xyz]
            by_ch = (got[0][..., 3:] - ref[0][..., 3:]).nan_to_num(0).abs() \
                .amax(dim=(0, 1, 2)).tolist()
            top = float(ref[0][..., 3:].nan_to_num(0).abs().max())
            err = max(errs)
            check(err <= 1e-5 * max(top, 1.0), f"roi_crop xyz differs by "
                  f"{err:.3e} (x, y, z: {by_ch}) at {what}")
            worst = max(worst, err)
            print(f"kernel: roi_crop {what}: RGB and coordinate map "
                  f"bit-equal, xyz max_abs_err {err:.3e} (x, y, z "
                  f"{by_ch[0]:.1e} {by_ch[1]:.1e} {by_ch[2]:.1e}; tol "
                  f"{1e-5 * max(top, 1.0):.1e}) [{card}]")

    # the served batch: one frame, 16 detections, as Predictor hands it over
    _, args, _ = roi_crop_shape("served", dev)
    S, O = d.input_res, d.out_res

    def kernel():
        return roi_crop(*args, S, O, d.pixel_mean, d.pixel_std)

    def plain():
        return roi_crop_plain(*args, S, O, d.pixel_mean, d.pixel_std)

    lib = library_roi_crop(args[0], args[1], args[4], args[5], args[6], S)
    crop = roi_crop(*args, S, O, d.pixel_mean, d.pixel_std,
                    normalize=False)[0]
    lib_err = float((lib()[:, :3].permute(0, 2, 3, 1) - crop[..., :3])
                    .abs().max())
    check(lib_err <= 0.5, f"grid_sample's RGB crop differs from the "
          f"kernel's by {lib_err:.3e}: not the same crop")
    ms = queued_ms(kernel, iters=200)
    prof_ms = device_ms(kernel, iters=200)
    events_ms = cuda_ms(kernel, iters=200)
    # the plain chain's kernels' own time: queued behind filler work, its
    # copies of mean and std from pageable memory drain the stream and it
    # runs at the host's launch rate
    plain_ms = device_ms(plain, iters=20)
    plain_q_ms = queued_ms(plain, iters=20, filler=8192)
    lib_ms = queued_ms(lib, iters=200)
    bound_ms, bound_by = roi_crop_bound(args[0], args[1], args[4], args[5],
                                        args[6], S, O)
    print(f"kernel: roi_crop served batch, {SERVE_BATCH} ROIs of one 480x640 "
          f"frame -> {S}/{O}, uint8 RGB, depth in metres: device time "
          f"(queued) {ms:.5f} ms, {100 * bound_ms / ms:.1f}% of bound "
          f"(profiler {prof_ms:.5f} ms; CUDA events over a burst "
          f"{events_ms:.5f} ms), plain {plain_ms:.4f} ms of device time "
          f"(queued {plain_q_ms:.4f} ms), grid_sample of the 4 planes (crop "
          f"only, no back-projection; RGB within {lib_err:.1e} of the "
          f"kernel's) {lib_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}) "
          f"[{card}]")
    times = dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
    for name in ("eval", "train"):
        what, args, normalize = roi_crop_shape(name, dev)
        got = roi_crop(*args, S, O, d.pixel_mean, d.pixel_std,
                       normalize=normalize)
        ref = roi_crop_plain(*args, S, O, d.pixel_mean, d.pixel_std,
                             normalize=normalize)
        torch.cuda.synchronize()
        check(same_bits(got[0], ref[0]) and same_bits(got[1], ref[1]),
              f"roi_crop differs from its plain version at the {what}")
        q_ms = queued_ms(lambda: roi_crop(*args, S, O, d.pixel_mean,
                                          d.pixel_std, normalize=normalize),
                         iters=200)
        b_ms, b_by = roi_crop_bound(args[0], args[1], args[4], args[5],
                                    args[6], S, O)
        print(f"kernel: roi_crop {what}: bit-equal to plain; device time "
              f"(queued) {q_ms:.5f} ms, {100 * b_ms / q_ms:.1f}% of its "
              f"bound {b_ms:.5f} ms ({b_by}) [{card}]")
        times[f"{name}_ms"], times[f"{name}_bound_ms"] = q_ms, b_ms
    return worst, times


class PreprocessCalls:
    """Counts the batches preprocessed inside a ``with`` block: the calls
    of ``preprocess_rois_grouped`` through the names the predictor, the
    trainer and the eval runner (at each call, from the pipeline module)
    reach it by, summed over the blocks it is used in."""

    def __init__(self):
        self.n = 0
        self.sizes: set[tuple[int, int]] = set()   # (H, W) of the frames

    def __enter__(self):
        from rdpn6d_tpu_torch.data import pipeline
        from rdpn6d_tpu_torch.engine import predictor, trainer

        self._mods = (pipeline, predictor, trainer)
        self._orig = pipeline.preprocess_rois_grouped

        def counted(cfg, frames, *a, **kw):
            self.n += 1
            self.sizes.add(tuple(frames["rgb"].shape[1:3]))
            return self._orig(cfg, frames, *a, **kw)

        for m in self._mods:
            m.preprocess_rois_grouped = counted
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            m.preprocess_rois_grouped = self._orig
        return False


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
    with PreprocessCalls() as calls:
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
    check(launches.get("roi_crop", 0) == calls.n == TRAIN_STEPS,
          f"roi_crop launched {launches.get('roi_crop', 0)} times for "
          f"{calls.n} preprocessed batches in {TRAIN_STEPS} train steps")
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


def train_parity(dev, work, batches=None, label="train parity", opts=(),
                 prepare=None):
    """Phase 7: one float32 step on the card and on the CPU from the same
    weights and the same (CPU-preprocessed) batch, or each side's own of
    ``batches`` ({"card", "cpu"}, preprocessed; phase 15(c)'s flat
    batches); ``opts`` are config opts on top of lm13's (phase 16(d)'s
    model variants), ``prepare(model)`` edits the seeded model first.
    Every loss within 1e-3 relative. ``grad_norm`` within 1e-3
    relative or twice what the CPU's own ``grad_norm`` moves when the
    input moves by 1e-6 relative, the larger: at this seeded init the
    gradient is ill-conditioned (BatchNorm on batch statistics of 4 ROIs),
    and a float32 reordering is a perturbation of that size."""
    import torch

    from rdpn6d_tpu_torch.data.pipeline import preprocess_rois_grouped
    from rdpn6d_tpu_torch.models import RDPN, init_weights
    from rdpn6d_tpu_torch.parallel import create_train_state, make_train_step
    from rdpn6d_tpu_torch.solver import build_schedule

    cfg = train_config(amp=False, out_dir=os.path.join(work, "phase7")
                       ).apply_opts(list(opts))
    if batches is None:
        frames, rois = train_inputs(cfg, 30, 2, 2)
        batch = preprocess_rois_grouped(
            cfg, {k: torch.from_numpy(v) for k, v in frames.items()},
            {k: torch.from_numpy(v) for k, v in rois.items()}, train=True,
            generator=torch.Generator().manual_seed(0))
        batches = {"card": batch, "cpu": batch}
    schedule = build_schedule(cfg, 1000)
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(1))
    if prepare is not None:
        prepare(model)
    cpu = torch.device("cpu")
    out = {}
    for name, d, src, scale in (("card", dev, "card", 1.0),
                                ("cpu", cpu, "cpu", 1.0),
                                ("cpu_moved", cpu, "cpu", 1.0 + 1e-6)):
        m = copy.deepcopy(model).to(d)
        state = create_train_state(cfg, m, lr=schedule(0))
        b = {k: v.to(d) for k, v in batches[src].items()}
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
        check(rel("card", k) <= tol, f"{label}: {k} card "
              f"{out['card'][k]:.6g} vs CPU {out['cpu'][k]:.6g} (tol {tol})")
        if k != "grad_norm":
            worst = max(worst, rel("card", k))
    print(f"{label}: f32 step, 4 ROIs, card vs CPU: total_loss "
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
    ``work/data``; returns the kernels' launches in ``main``'s run and its
    MEAN table."""
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
    with PreprocessCalls() as calls:
        res = port_main.main([
            "--config-file",
            os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "lm13.py"),
            "--eval-only", "--opts", f'train.output_dir="{out}"'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(cuda_build.LAUNCHES)
    launches = got.get("min_dist2", 0)
    check(list(res) == ["lm_13_test"], f"main evaluated {list(res)}")
    res = res["lm_13_test"]
    check(launches == len(objs), f"min_dist2 launched {launches} times "
          f"for {len(objs)} scored objects")
    n_batches = -(-n_rois // 32)       # run_eval's batches of 32
    check(got.get("roi_crop", 0) == calls.n == n_batches,
          f"roi_crop launched {got.get('roi_crop', 0)} times for "
          f"{calls.n} preprocessed batches ({n_batches} expected)")
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
          f"decode, model, scoring, CSV, curves); min_dist2 x{launches}, "
          f"roi_crop x{got.get('roi_crop', 0)} in {calls.n} batches; "
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
    return got, res["mean"]


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
            with PreprocessCalls() as calls:
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
        rec.update(wall=wall, launches=got, state=state, batches=calls.n,
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
        # one an iteration and one an eval batch
        check(r["launches"].get("roi_crop", 0) == r["batches"] >= n,
              f"roi_crop launched {r['launches'].get('roi_crop', 0)} times "
              f"for {r['batches']} preprocessed batches ({n} iterations)")
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
        with PreprocessCalls() as calls:
            state = port_main.main(["--config-file", config, "--opts",
                                    *opts])
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
    # one an iteration, colour-augmented or not, and one an eval batch
    check(launches.get("roi_crop", 0) == calls.n > iters,
          f"roi_crop launched {launches.get('roi_crop', 0)} times for "
          f"{calls.n} preprocessed batches ({iters} iterations and the eval)")
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
        qdq = queued_ms(lambda: quantize_act(x, "dynamic"), iters=30)
        print(f"kernel: quantize_act {C}x{H}x{W} B={B} bf16 in: static "
              f"device time {qq:.4f} ms (queued; "
              f"{100 * q[0] / qq:.1f}% of bound), {qk:.4f} by CUDA events "
              f"over a burst; dynamic {qdq:.4f} (queued), {qd:.4f} (events);"
              f" bound {q[0]:.4f} ms ({q[1]}); plain {qp:.4f} [{card}]")
        times[label] = ({"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": lib_ms},
                        # device time: a burst of this op is bound by
                        # the wrapper's host time
                        {"ms": qq, "events_ms": qk, "plain_ms": qp,
                         "bound_ms": q[0], "bound_by": q[1],
                         "library_ms": None})
    first = times[INT8_HEAD[0][0]]
    return conv_err, quant_err, first[0], first[1]


# phase 12(a)'s fused quantizer (label, B, C1, C2, H, W): lm13's head at
# B = 16 (256 BN'd channels, the first conv's 256 + rot_concat's 64 skip
# channels), the trunk's widest, channels not a multiple of 32, H W not a
# multiple of 8 (scalar loads) or of the 64-pixel tile, B = 1
FUSED_HEAD = [("head 256", 16, 256, 0, 64, 64),
              ("head 256 + 64 skip", 16, 256, 64, 64, 64)]
FUSED_RAGGED = ("40 + 8 skip at 7x33 (scalar loads)", 3, 40, 8, 7, 33)
FUSED_SHAPES = FUSED_HEAD + [
    ("512 at 8x8", 16, 512, 0, 8, 8), FUSED_RAGGED,
    ("72 at 6x20 (a partial pixel tile)", 2, 72, 0, 6, 20),
    ("33 + 31 skip, B = 1", 1, 33, 31, 8, 8)]


def bn_relu_quantize_bound(B, C1, C2, H, W, elem=2) -> tuple[float, str]:
    """Least ms for ``bn_relu_quantize``: y and skip (``elem`` bytes an
    element) and the BN's 3 C1 float32 constants read once, xq (padded
    to 32 channels) and sx written once; an FMA, a divide and a round an
    element are far below the card's rate."""
    from rdpn6d_tpu_torch.ops.int8_conv import padded_channels

    return 1e3 * (elem * B * (C1 + C2) * H * W + 12 * C1
                  + B * H * W * padded_channels(C1 + C2) + 4 * B) \
        / HBM_BYTES_PER_S, "bytes"


def fused_case(dev, shape, mode, dtype, seed):
    """Seeded inputs of ``bn_relu_quantize`` on the card: (y, skip, a
    ``BatchNorm2d`` in eval mode, its folded constants, amax, t), the
    static amax taken from the plain activation (some inputs clip)."""
    import torch

    from rdpn6d_tpu_torch.models.norm import BatchNorm2d
    from rdpn6d_tpu_torch.ops.int8_conv import bn_relu_plain

    _, B, C1, C2, H, W = shape
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(B, C1, H, W, generator=g) \
        * (torch.rand(C1, generator=g) * 3)[None, :, None, None]
    skip = torch.randn(B, C2, H, W, generator=g).clamp_min(0) if C2 \
        else None
    bn = BatchNorm2d(C1)
    with torch.no_grad():
        bn.weight.copy_(torch.randn(C1, generator=g))
        bn.bias.copy_(torch.randn(C1, generator=g) * 0.5)
        bn.running_mean.copy_(torch.randn(C1, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(C1, generator=g) * 2 + 0.05)
    bn = bn.eval().to(dev)
    y = y.to(dev, dtype)
    skip = None if skip is None else skip.to(dev, dtype)
    consts = bn.folded()
    a = bn_relu_plain(y, *consts, skip).float()
    amax = t = None
    if mode == "static":
        amax = a.abs().amax() * 0.9
    elif mode == "per_channel":
        t = (torch.rand(C1 + C2, generator=g) + 0.25).to(dev)
        amax = (a.abs().amax(dim=(0, 2, 3)) / t).amax() * 0.9
    return y, skip, bn, consts, amax, t


def check_bn_relu_quantize(dev, card):
    """Phase 12(a) for ``bn_relu_quantize``: the kernel against its plain
    version on the card in every mode, bfloat16 and float32, at every
    shape of ``FUSED_SHAPES`` (xq and sx bit-equal) and with a NaN in y
    and in the skip; then its time at the head shapes by CUDA events and
    ``queued_ms`` beside its bound, its plain version and the unfused
    sequence it replaces (torch's BN, ReLU, ``torch.cat`` and
    ``quantize_act``), timed in the same run. Returns (max_abs_err, the
    kernels line's times: the head's 256 + 64 shape, static, bf16)."""
    import torch
    import torch.nn.functional as F

    from rdpn6d_tpu_torch.ops.int8_conv import (
        bn_relu_quantize,
        bn_relu_quantize_plain,
        quantize_act,
    )

    def same(a, b):
        return torch.equal(a.isnan(), b.isnan()) \
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))

    err = 0.0
    for i, shape in enumerate(FUSED_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            for mode in INT8_MODES:
                y, skip, _, consts, amax, t = fused_case(dev, shape, mode,
                                                         dtype, 200 + i)
                xq, sx = bn_relu_quantize(y, *consts, mode, amax, t, skip)
                rq, rs = bn_relu_quantize_plain(y, *consts, mode, amax, t,
                                                skip)
                torch.cuda.synchronize()
                e = float((xq.int() - rq.int()).abs().max()) \
                    + float((sx - rs).abs().max())
                check(torch.equal(xq, rq) and torch.equal(sx, rs),
                      f"bn_relu_quantize {mode} {dtype} at {shape[0]}: xq "
                      f"or sx differ from the plain version's ({e:.3e})")
                err = max(err, e)
        print(f"kernel: bn_relu_quantize {shape[0]} B={shape[1]} "
              f"{shape[4]}x{shape[5]}, bf16 / f32 x dynamic / static / "
              "per_channel: xq and sx bit-equal to the plain version")
    shape = FUSED_RAGGED
    for mode in INT8_MODES:
        y, skip, _, consts, amax, t = fused_case(dev, shape, mode,
                                                 torch.bfloat16, 7)
        y[0, 3, 2, 4] = float("nan")
        skip[0, 5, 6, 1] = -float("nan")
        xq, sx = bn_relu_quantize(y, *consts, mode, amax, t, skip)
        rq, rs = bn_relu_quantize_plain(y, *consts, mode, amax, t, skip)
        torch.cuda.synchronize()
        check(torch.equal(xq, rq) and same(sx, rs)
              and int(xq[0, 2, 4, 3]) == 0 and int(xq[0, 6, 1, 45]) == 0
              and bool(sx[0].isnan()) == (mode == "dynamic")
              and bool(sx[1].isfinite()),
              f"bn_relu_quantize with a NaN, {mode}: not as the plain "
              "version")
    print(f"kernel: bn_relu_quantize {shape[0]} with a NaN in y and in the "
          "skip of sample 0, dynamic / static / per_channel: as the plain "
          "version (dynamic: the sample's scale NaN; a NaN quantized to 0)")

    times = {}
    for i, shape in enumerate(FUSED_HEAD):
        label, B, C1, C2, H, W = shape
        bound, by = bn_relu_quantize_bound(B, C1, C2, H, W)
        for mode in INT8_MODES:
            y, skip, bn, consts, amax, t = fused_case(
                dev, shape, mode, torch.bfloat16, 300 + i)

            def fused():
                return bn_relu_quantize(y, *consts, mode, amax, t, skip)

            def unfused():
                a = F.relu(bn(y))
                if skip is not None:
                    a = torch.cat([a, skip], dim=1)
                return quantize_act(a, mode, amax, t)

            ms = cuda_ms(fused, iters=50)
            q_ms = queued_ms(fused, iters=30)
            u_ms = cuda_ms(unfused, iters=50)
            uq_ms = queued_ms(unfused, iters=30)
            plain_ms = cuda_ms(lambda: bn_relu_quantize_plain(
                y, *consts, mode, amax, t, skip), iters=3, warmup=1)
            print(f"kernel: bn_relu_quantize {label} B={B} {H}x{W} bf16 "
                  f"{mode}: device time {q_ms:.4f} ms (queued; "
                  f"{100 * bound / q_ms:.1f}% of bound), {ms:.4f} by CUDA "
                  f"events over a burst; bound {bound:.4f} ms ({by}); the "
                  f"unfused BN + ReLU{' + cat' if skip is not None else ''}"
                  f" + quantize_act {u_ms:.4f} (queued {uq_ms:.4f}); plain "
                  f"{plain_ms:.4f} [{card}]")
            if mode == "static" and skip is not None:
                # device time: a burst of this op is bound by the
                # wrapper's host time
                times = {"ms": q_ms, "events_ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": by,
                         "library_ms": None}
    return err, times


def int8_hooks(model, feed=None):
    """Hooks on ``model``'s serving Int8Convs (not calibration passes):
    record each conv's arguments (its input; where it folds the BN before
    it, that BN's input, the BN and the skip) and its output, in call
    order; with ``feed`` (a list of such arguments in call order) each conv
    takes the fed input and skip in place of its own, keeping its own BN.
    Returns (arguments, outputs, handles)."""
    import torch

    from rdpn6d_tpu_torch.models.quant import Int8Conv

    calls, outputs = [], []

    def pre(mod, args):
        if mod.calibrating:
            return None
        if feed is not None:
            fed, dev = feed[len(calls)], args[0].device
            args = (fed[0].to(dev),) if len(args) == 1 else (
                fed[0].to(dev), args[1],
                None if fed[2] is None else fed[2].to(dev))
        calls.append(tuple(a.detach().clone()
                           if isinstance(a, torch.Tensor) else a
                           for a in args))
        return None if feed is None else args

    def post(mod, args, out):
        if not mod.calibrating:
            outputs.append(out.detach().clone())

    handles = []
    for m in model.modules():
        if isinstance(m, Int8Conv):
            handles += [m.register_forward_pre_hook(pre),
                        m.register_forward_hook(post)]
    return calls, outputs, handles


def quantized_input_plain(args, mode, amax, t):
    """xq of what an Int8Conv called with ``args`` (on the CPU)
    quantizes, by the plain versions."""
    from rdpn6d_tpu_torch.ops.int8_conv import (
        bn_relu_quantize_plain,
        quantize_act_plain,
    )

    if len(args) > 1 and args[1] is not None:
        return bn_relu_quantize_plain(args[0], *args[1].folded(), mode,
                                      amax, t, args[2])
    return quantize_act_plain(args[0], mode, amax, t)


def args_to_cpu(args):
    """An Int8Conv call's arguments on the CPU (a copy of its BN)."""
    import torch

    return tuple(a.cpu() if isinstance(a, torch.Tensor) else
                 None if a is None else copy.deepcopy(a).cpu()
                 for a in args)


# phase 12(b)'s served traffic: frames that each fill the Predictor's
# batch of 16, every mode in turns, twice round
INT8_SERVE_FRAMES = 16
INT8_SERVE_TURNS = ("bf16", "int8-head-static", "int8-head", "int8-head",
                    "int8-head-static", "bf16") * 2


def serve_counted(pred, frames, name, n_int8, n_fold):
    """One served pass with the launches counted from zero: checks every
    pose finite, ``n_int8`` ``int8_conv`` launches a frame (one batch a
    frame; none for a float model), ``n_fold`` of them quantized by
    ``bn_relu_quantize`` and the rest by ``quantize_act``. Returns
    (poses/s, launches)."""
    from rdpn6d_tpu_torch.ops import cuda_build

    n_det = sum(len(f[2]) for f in frames)
    cuda_build.reset_launches()
    outs, secs = serve(pred, frames)
    got = dict(cuda_build.LAUNCHES)
    flat = [r for o in outs for r in o]
    check(len(flat) == n_det and all(
        np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all()
        for r in flat), f"{name}: non-finite or missing poses")
    want = {"int8_conv": n_int8, "bn_relu_quantize": n_fold,
            "quantize_act": n_int8 - n_fold}
    check(all(got.get(k, 0) == v * len(frames) for k, v in want.items()),
          f"{name}: int8 launches {got}, want {want} a frame")
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
    from rdpn6d_tpu_torch.utils.flax_params import load_quant, quant_tree

    c = cfg.apply_opts(opts)
    gp, cp = (physical_z(Predictor(c, assets, batch_size=16,
                                   dtype=torch.float32, device=d,
                                   allow_random_init=True))
              for d in ("cuda", "cpu"))
    n8 = sum(isinstance(m, Int8Conv) for m in gp.model.modules())
    rgb, depth, dets = frame
    g_calls, g_out, hs = int8_hooks(gp.model)
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
    c_calls, c_out, hs = int8_hooks(cp.model, feed=g_calls)
    carried = cp.predict(rgb, depth, K_LM, dets)
    for h in hs:
        h.remove()
    check(len(c_out) == len(g_out) == n8, f"{label}: {len(c_out)} CPU and "
          f"{len(g_out)} card int8 conv calls, want {n8}")
    for i, (a, b) in enumerate(zip(g_out, c_out)):
        check(torch.equal(a.cpu(), b), f"{label}: int8 conv {i}: card and "
              "CPU outputs differ on the same input")
    n_fold = sum(len(c) > 1 and c[1] is not None for c in g_calls)
    dR, dt = pose_diff(carried)
    print(f"parity: {label} over {len(dets)} ROIs, the card's scales and "
          f"each int8 conv's input carried to the CPU ({n_fold} of them the "
          f"input of the BN folded into the conv, with its skip): all {n8} "
          f"int8 conv outputs bit-equal; max |dR| {dR:.3e}, max |dt|/|t| "
          f"{dt:.3e} (tol 1e-3) [{card}]")
    check(dR <= 1e-3 and dt <= 1e-3, f"{label}: poses disagree")
    if not free_running:
        return
    f_calls, _, hs = int8_hooks(cp.model)
    free = cp.predict(rgb, depth, K_LM, dets)
    for h in hs:
        h.remove()
    flips = []
    for m, a, b in zip(
            [m for m in cp.model.modules() if isinstance(m, Int8Conv)],
            g_calls, f_calls):
        _, _, amax, t = m.quantized()
        mode = "per_channel" if m.per_channel else "static"
        qa, _ = quantized_input_plain(args_to_cpu(a), mode, amax, t)
        qb, _ = quantized_input_plain(b, mode, amax, t)
        flips.append(f"{int((qa != qb).sum())}/{qa.numel()}")
    dR, dt = pose_diff(free)
    print(f"parity: {label}, free-running (each on its own activations): "
          f"max |dR| {dR:.3e}, max |dt|/|t| {dt:.3e}; activations quantized "
          f"differently conv by conv {', '.join(flips)} (reported, not "
          "gated)")


def profiled_calls(fn, iters: int) -> tuple[float, float]:
    """(device ms, kernel launches) a call of ``fn``, from torch.profiler
    over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if str(e.device_type).endswith("CUDA")
          and e.self_device_time_total > 0
          and not getattr(e, "is_user_annotation", False)]
    check(bool(ev), "the profiler saw no device time")
    return (sum(e.self_device_time_total for e in ev) / 1e3 / iters,
            sum(e.count for e in ev) / iters)


def unfused_head(head, x, skip64=None):
    """``head``'s forward op by op, as before the fold: each BN, ReLU and
    the concat run apart, and each int8 conv quantizes its own input
    through ``quantize_act`` (the sequence ``bn_relu_quantize`` replaces).
    Returns the logits."""
    import torch

    from rdpn6d_tpu_torch.ops.resize import upsample_bilinear_align_corners

    f = head.features
    x = f[2](f[1](f[0](x)))
    if skip64 is not None:
        x = torch.cat([x, skip64.to(x.dtype)], dim=1)
    for i in range(head.num_layers):
        if i >= 3:
            x = upsample_bilinear_align_corners(x, x.shape[2] * 2,
                                                x.shape[3] * 2)
        for j in range(2):
            k = 3 + 3 * (2 * i + j)
            x = f[k + 2](f[k + 1](f[k](x)))
    return f[-1](x).float()


def head_device_time(pred, frame, label, card, int8: bool) -> dict:
    """The head of ``pred`` on the input one served batch of 16 gives it:
    device ms a call (``queued_ms`` behind a 4096² float32 product, and
    the profiler's sum) and kernel launches a call (profiler); for an
    int8 BN head also run op by op (``unfused_head``: the unfused
    sequence). Prints them and returns {"fused"|"unfused"|"float":
    (queued ms, profiler ms, launches)}."""
    import torch

    head = pred.model.rot_head_net
    seen = {}

    def grab(mod, args, kwargs):
        seen["args"], seen["kwargs"] = args, kwargs

    h = head.register_forward_pre_hook(grab, with_kwargs=True)
    rgb, depth, dets = frame
    pred.predict(rgb, depth, K_LM, dets)
    h.remove()
    B = seen["args"][0].shape[0]
    kinds = (("fused", head), ("unfused", lambda *a, **k: unfused_head(
        head, *a, **k))) if int8 else (("float", head),)
    out = {}
    for name, fn in kinds:
        def run():
            with torch.no_grad():
                return fn(*seen["args"], **seen["kwargs"])
        out[name] = (queued_ms(run, iters=20, filler=4096),
                     *profiled_calls(run, iters=10))
    line = "; ".join(f"{k} {q:.4f} ms (profiler {p:.4f}), {n:.0f} kernel "
                     f"launches" for k, (q, p, n) in out.items())
    print(f"serve: lm13 full width {label} head (convT to the 1x1 output "
          f"conv) at B = {B}, device time a batch: {line} [{card}]")
    return out


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
    n_fold = n8 - max(0, cfg.head.num_layers - 3)  # none behind an upsample
    launches = {"int8_conv": 0, "quantize_act": 0, "bn_relu_quantize": 0}
    rates = {k: [] for k in preds}
    for name in INT8_SERVE_TURNS:
        float_model = name == "bf16"
        rate, got = serve_counted(preds[name], full, name,
                                  0 if float_model else n8,
                                  0 if float_model else n_fold)
        if name != "bf16":
            for k in launches:
                launches[k] += got.get(k, 0)
        rates[name].append(rate)
    folds = f"; {n8} int8_conv and {n_fold} bn_relu_quantize launches a batch"
    for name, r in rates.items():
        print(f"serve: lm13 full width {name}: {n_det} poses from "
              f"{len(full)} frames of 16 detections (one batch of 16 a "
              f"frame) a pass, poses/s {' '.join(f'{v:.1f}' for v in r)} "
              f"(median {float(np.median(r)):.1f}; in turns: "
              f"{', '.join(INT8_SERVE_TURNS[:6])}, twice)"
              f"{'' if name == 'bf16' else folds}"
              f" [{card}]")
    # the head's device time a batch of 16, fused against the unfused
    # sequence (the same model run op by op) and bf16's head
    heads = {name: head_device_time(preds[name], full[0], name, card,
                                    int8=name != "bf16")
             for name in ("int8-head-static", "int8-head", "bf16")}
    for name in ("int8-head-static", "int8-head"):
        fewer = heads[name]["unfused"][2] - heads[name]["fused"][2]
        check(fewer >= 2 * n_fold + 1, f"{name} head: {fewer:.0f} fewer "
              f"kernel launches fused than unfused, want >= "
              f"{2 * n_fold + 1} (a BN and a ReLU a fold and the concat)")
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
    rate, got = serve_counted(p_all, full, "int8-all", n_all, n_fold)
    for k in launches:
        launches[k] += got.get(k, 0)
    print(f"serve: lm13 full width int8-all per-channel: {n_det} poses, "
          f"{rate:.1f} poses/s; {n_all} int8 convs a batch (trunk and "
          f"head), launches {got} [{card}]")
    # that model's int8 convs on phase 3's first frame, each against a CPU
    # copy of the module (plain versions) on the card's input to it
    g_calls, g_out, hs = int8_hooks(p_all.model)
    rgb, depth, dets = frames[0]
    p_all.predict(rgb, depth, K_LM, dets)
    for h in hs:
        h.remove()
    convs = [m for m in p_all.model.modules() if isinstance(m, Int8Conv)]
    check(len(g_calls) == len(g_out) == n_all,
          f"int8-all: {len(g_calls)} int8 conv calls, want {n_all}")
    with torch.no_grad():
        for i, (m, args, y) in enumerate(zip(convs, g_calls, g_out)):
            ref = copy.deepcopy(m).cpu()(*args_to_cpu(args))
            check(torch.equal(y.cpu(), ref), f"int8-all bf16 pass: int8 "
                  f"conv {i} differs from its CPU copy on the card's input")
    print(f"parity: int8-all per-channel bf16 served batch of {len(dets)}: "
          f"all {n_all} int8 conv outputs ({n_fold} with the BN before them "
          f"folded) bit-equal to the CPU's (plain versions) on the card's "
          f"inputs [{card}]")

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
    with PreprocessCalls() as calls:
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
          and got.get("bn_relu_quantize", 0) == want
          and got.get("quantize_act", 0) == 0
          and got.get("min_dist2", 0) == 13,
          f"int8 eval launches {got}, want int8_conv and bn_relu_quantize "
          f"{want}, quantize_act 0, min_dist2 13")
    # the static calibration preprocesses the first batch once more
    check(got.get("roi_crop", 0) == calls.n == -(-n_rois // 32) + 1,
          f"int8 eval: roi_crop launched {got.get('roi_crop', 0)} times for "
          f"{calls.n} preprocessed batches")
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


# phase 13(a): the data-parallel step on two gloo ranks of the one card
DIST_RANKS = 2
DIST_STEPS = 3
# conv biases right before a batch-statistics BatchNorm: their gradient is
# zero in exact arithmetic, so their values are rounding
BN_CANCELLED = ("backbone.spatial_net.xyz_emb.bias",
                "backbone.spatial_net.conv1.bias",
                "backbone.spatial_net.conv2.bias",
                "backbone.spatial_net.conv3.bias")


def dist_config(amp: bool):
    """Phase 13(a)'s lm13 at full width, 24 global ROIs, no DZI jitter: the
    train preprocessing is then the same function of each ROI on a rank
    and in one process, so both take the same batches."""
    return train_config(amp, out_dir="").apply_opts(['data.dzi_type="none"'])


def rank_share(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s equal share of a raw grouped batch whose ROIs are
    ordered by frame: its rows of the ROIs and the frames they read."""
    rois = batch["rois"]
    per = rois["frame_idx"].shape[0] // world
    mine = {k: v[rank * per:(rank + 1) * per] for k, v in rois.items()}
    lo = int(mine["frame_idx"].min())
    hi = int(mine["frame_idx"].max()) + 1
    mine["frame_idx"] = mine["frame_idx"] - lo
    return {"frames": {k: v[lo:hi] for k, v in batch["frames"].items()},
            "rois": mine}


def dist_steps(dev, sd_path: str, raw: list, scale: float = 1.0,
               full: bool = True) -> dict:
    """Phase 13(a) in one process: the f32 steps (TF32 off) on ``raw``,
    preprocessed here (``train=True``) and, with ``scale`` != 1, the
    network input scaled by it; then, with ``full``, the same steps with
    the model and the network inputs in float64, and as many bf16 steps,
    each timed to a synchronize, and the gradient all-reduce's time. All
    from the same weights. In a process group this is one rank on its
    share of each global batch (``make_sharded_train_step``); in none, the
    one process on the global batch (``make_train_step``). Returns the
    metrics and final state of the f32 and float64 runs, the kernels'
    launches and the preprocessed batches of the f32 run, and the times."""
    import torch

    from rdpn6d_tpu_torch.data import pipeline
    from rdpn6d_tpu_torch.models import RDPN
    from rdpn6d_tpu_torch.ops import cuda_build
    from rdpn6d_tpu_torch.parallel import (
        create_train_state,
        make_sharded_train_step,
        make_train_step,
        mesh,
    )
    from rdpn6d_tpu_torch.parallel.train_step import all_reduce_grads
    from rdpn6d_tpu_torch.solver import build_schedule

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = torch.load(sd_path, map_location="cpu", weights_only=True)
    batches = [{part: {k: torch.from_numpy(v).to(dev)
                       for k, v in b[part].items()} for part in b}
               for b in raw]
    if mesh.in_group():
        batches = [rank_share(b, mesh.rank(), mesh.world())
                   for b in batches]

    def run(amp: bool, dtype, hook):
        cfg = dist_config(amp)
        model = RDPN(cfg)
        model.load_state_dict(sd)
        model = mesh.replicate(model.to(dev, dtype))
        schedule = build_schedule(cfg, 1000)
        state = create_train_state(cfg, model, lr=schedule(0))
        step = (make_sharded_train_step if mesh.in_group()
                else make_train_step)(cfg, schedule)
        gen = torch.Generator(device=dev).manual_seed(0)
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # through the module, where PreprocessCalls counts it
            batch = pipeline.preprocess_rois_grouped(
                cfg, b["frames"], b["rois"], train=True, generator=gen)
            if scale != 1.0:
                batch["roi_img"] = batch["roi_img"] * scale
            batch = {k: v.to(dtype) if v.is_floating_point() else v
                     for k, v in batch.items()}
            state, m = step(state, batch)
            torch.cuda.synchronize()
            hook(m, time.perf_counter() - t0)
        return model

    def parity(dtype):
        metrics: list = []
        model = run(False, dtype, lambda m, _: metrics.append(
            {k: float(v) for k, v in m.items()}))
        return {"metrics": metrics,
                "state": {k: v.detach().cpu() for k, v in
                          model.state_dict().items()}}

    cuda_build.reset_launches()
    with PreprocessCalls() as calls:
        out = parity(torch.float32)
    out.update(launches=dict(cuda_build.LAUNCHES), batches=calls.n)
    if full:
        out["f64"] = parity(torch.float64)
        ms: list = []
        model = run(True, torch.float32, lambda m, s: ms.append(1e3 * s))
        out["bf16_ms"] = ms
        if mesh.in_group():
            params = list(model.parameters())
            reps = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                all_reduce_grads(params)
                torch.cuda.synchronize()
                reps.append(1e3 * (time.perf_counter() - t0))
            out["all_reduce_ms"] = reps
            out["grad_mb"] = sum(p.grad.numel() * p.grad.element_size()
                                 for p in params if p.grad is not None) / 2**20
    torch.cuda.empty_cache()
    return out


def _state_errors(ref: dict, got: dict, init: dict):
    """Per floating leaf (the BN-cancelled biases aside): (name, max
    |got - ref|, max |ref|, max |ref - init|)."""
    for k, v in ref.items():
        if k in BN_CANCELLED or not v.is_floating_point():
            continue
        yield (k, float((got[k].double() - v.double()).abs().max()),
               float(v.abs().max()),
               float((v.double() - init[k].double()).abs().max()))


def run_dist_ranks(dev, card, work) -> dict:
    """Phase 13(a): two gloo ranks on the one card (NCCL refuses two ranks
    of one device) against one process on the global batch, lm13 at full
    width, 24 ROIs (12 a rank), 3 steps from one seeded init on
    card-resident batches preprocessed on each side, TF32 off.

    Tolerances. In float64 (the model and its inputs; the preprocessing
    and the points where the model rounds to float32 stay float32), the
    step the CPU tests hold the 2-rank step to at 1e-5 (measured ~1e-13
    there): every loss and ``grad_norm`` at every step within 1e-5
    relative, every parameter and BatchNorm statistic within 1e-5 of its
    leaf's largest value (the biases that feed a batch-statistics
    BatchNorm are rounding and are not compared). In f32, of phase 7's
    kind: every loss at every step, and ``grad_norm`` at the first step
    (equal weights), within 1e-3 relative or twice what the one
    process's own value moves when its input moves by 1e-6 relative, the
    larger. The f32 ``grad_norm`` of later steps and the f32 parameters
    are reported, not gated: at this init a float32 reordering, or the
    card's run-to-run rounding, parts them by a few per cent by the third
    step (one run missed the tolerance above by 2.4x on step 3's
    ``grad_norm``, 289.3 against 282.9). The ranks end bit-equal in both runs. Each rank
    launches ``roi_crop`` once a preprocessed batch and ``gt_labels`` once
    a step, counted in its own process. Then 3 bf16 steps timed on each
    side, and the gradient all-reduce. Returns the ranks' summed
    launches."""
    import torch

    from rdpn6d_tpu_torch.models import RDPN, init_weights
    from rdpn6d_tpu_torch.parallel import spawn

    cfg = dist_config(amp=False)
    raw = []
    for s in range(DIST_STEPS):
        frames, rois = train_inputs(cfg, 40 + s, 8, TRAIN_ROIS // 8)
        raw.append({"frames": frames, "rois": rois})
    sd_path = os.path.join(work, "dist_init.pt")
    torch.save(init_weights(RDPN(cfg), torch.Generator().manual_seed(5))
               .state_dict(), sd_path)
    init = torch.load(sd_path, weights_only=True)
    one = dist_steps(dev, sd_path, raw)
    moved = dist_steps(dev, sd_path, raw, scale=1.0 + 1e-6, full=False)
    t0 = time.perf_counter()
    # both ranks on this card: an indexed device pins every rank to it
    ranks = spawn(dist_steps, DIST_RANKS, args=(sd_path, raw),
                  device=f"cuda:{torch.cuda.current_device()}",
                  backend="gloo")
    spawn_s = time.perf_counter() - t0

    for run in ("f32", "f64"):
        a, b = (r if run == "f32" else r["f64"] for r in ranks)
        check(a["metrics"] == b["metrics"], f"dist {run}: the ranks' "
              "metrics differ")
        for k, v in a["state"].items():
            check(torch.equal(v, b["state"][k]), f"dist {run}: the ranks' "
                  f"{k} differ")

    # float64: the trajectory
    worst64 = 0.0
    for i, (m, ref) in enumerate(zip(ranks[0]["f64"]["metrics"],
                                     one["f64"]["metrics"])):
        for k, v in ref.items():
            err = abs(m[k] - v) / max(abs(v), 1e-3)
            check(err <= 1e-5, f"dist f64 step {i + 1}: {k} two ranks "
                  f"{m[k]:.12g} vs one process {v:.12g}")
            worst64 = max(worst64, err)
    worst64_p, n_cmp = 0.0, 0
    for k, err, top, change in _state_errors(
            one["f64"]["state"], ranks[0]["f64"]["state"], init):
        check(err <= 1e-5 * top, f"dist f64: {k} two ranks vs one process "
              f"{err:.3g} (largest {top:.3g})")
        worst64_p = max(worst64_p, err / max(top, 1e-30))
        n_cmp += 1

    # f32: the first step and every loss, then what the run shows
    worst = {"loss": 0.0, "grad_norm": 0.0}
    later_gn = []
    for i, (m, ref, mv) in enumerate(zip(ranks[0]["metrics"],
                                         one["metrics"], moved["metrics"])):
        for k, v in ref.items():
            err = abs(m[k] - v)
            tol = max(1e-3 * abs(v), 2 * abs(mv[k] - v))
            if k == "grad_norm" and i > 0:
                later_gn.append(err / abs(v))
                continue
            check(bool(np.isfinite(m[k])) and err <= tol,
                  f"dist f32 step {i + 1}: {k} two ranks {m[k]:.6g} vs one "
                  f"process {v:.6g} (tol {tol:.3g})")
            key = "grad_norm" if k == "grad_norm" else "loss"
            worst[key] = max(worst[key], err / max(tol, 1e-30))
    p32 = max((err / max(change, top * 2.0 ** -23), k) for k, err, top,
              change in _state_errors(one["state"], ranks[0]["state"],
                                      init))
    for r, got in enumerate(ranks):
        la = got["launches"]
        check(la.get("roi_crop", 0) == got["batches"] == DIST_STEPS,
              f"dist rank {r}: roi_crop launched {la.get('roi_crop', 0)} "
              f"times for {got['batches']} preprocessed batches")
        check(la.get("gt_labels", 0) == DIST_STEPS,
              f"dist rank {r}: gt_labels launched {la.get('gt_labels', 0)}"
              f" times in {DIST_STEPS} steps")
    per = TRAIN_ROIS // DIST_RANKS
    print(f"dist: two gloo ranks on one card vs one process on the global "
          f"batch, lm13 full width, {TRAIN_ROIS} ROIs ({per} a rank), "
          f"{DIST_STEPS} steps, TF32 off: float64 "
          f"worst relative error of the losses and grad_norm {worst64:.3e}, "
          f"of {n_cmp} parameters and BN statistics {worst64_p:.3e} (tol "
          f"1e-5); f32 worst error / tolerance: losses {worst['loss']:.3f}, "
          f"step-1 grad_norm {worst['grad_norm']:.3f}; f32 reported: "
          f"grad_norm relative difference at steps 2-{DIST_STEPS} "
          f"{', '.join(f'{x:.3e}' for x in later_gn)}, the largest "
          f"parameter difference / its change {p32[0]:.3f} ({p32[1]}); "
          f"total_loss {[round(m['total_loss'], 6) for m in ranks[0]['metrics']]}"
          f" vs {[round(m['total_loss'], 6) for m in one['metrics']]}; ranks "
          f"bit-equal; launches a rank {[g['launches'] for g in ranks]} "
          f"for {[g['batches'] for g in ranks]} batches; spawn and the "
          f"ranks' runs {spawn_s:.1f} s [{card}]")

    def fmt(ms):
        return ", ".join(f"{x:.2f}" for x in ms)

    print(f"dist: bf16 ms/step (preprocessing + step, to a synchronize), "
          f"one process on {TRAIN_ROIS} ROIs: {fmt(one['bf16_ms'])}; two "
          f"ranks of {TRAIN_ROIS // DIST_RANKS} ROIs (two ranks time-share "
          f"one card; not a scaling number): rank 0 "
          f"{fmt(ranks[0]['bf16_ms'])}, rank 1 {fmt(ranks[1]['bf16_ms'])}"
          f"; gradient all-reduce over gloo ({ranks[0]['grad_mb']:.1f} MB "
          f"a rank) ms a step: rank 0 {fmt(ranks[0]['all_reduce_ms'])}, "
          f"rank 1 {fmt(ranks[1]['all_reduce_ms'])} [{card}]")
    launches: dict = {}
    for got in ranks:
        for k, v in got["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_multihost_cli(dev, card, work) -> dict:
    """Phase 13(b): ``main --multihost`` as the one process of a group of
    one over NCCL, on phase 10's trees and settings (lm13, 24 ROIs a step,
    the seeded .pth trunk): one epoch (6 iterations) with a checkpoint and
    eval on ``lm_13_test`` at its end (the predictions gathered over NCCL,
    ADI on ``min_dist2``), then ``--resume`` to a second epoch, evaluated
    again. Each ``main`` decodes its frames anew (its own host LRU and
    device cache), as phase 10's first epoch does. Checks the steps,
    checkpoints, ``metrics.json``, the CSV and the launches; prints ms/step
    and the loader's wait (``instrument_trainer``); returns the launches
    summed over both runs."""
    import torch

    from rdpn6d_tpu_torch import main as port_main
    from rdpn6d_tpu_torch.ops import cuda_build

    config = os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "lm13.py")
    out = os.path.join(work, "multihost")
    opts = ["train.log_period=1", "train.checkpoint_period_epochs=1",
            f"train.eval_period={ITERS_PER_EPOCH}",
            f'train.output_dir="{out}"']
    launches: dict = {}
    for epochs, resume in ((1, False), (2, True)):
        rec: dict = {}
        undo = instrument_trainer(rec)
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        try:
            with PreprocessCalls() as calls:
                state = port_main.main(
                    ["--config-file", config, "--multihost",
                     "--dist-coordinator", f"127.0.0.1:{free_port()}",
                     "--num-processes", "1", "--process-id", "0"]
                    + ["--resume"] * resume
                    + ["--opts", *opts, f"solver.total_epochs={epochs}"])
        finally:
            undo()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        step_ms = 1e3 * np.diff([rec["t0"]] + rec["stamps"])
        got = dict(cuda_build.LAUNCHES)
        n = ITERS_PER_EPOCH
        check(state.step == epochs * n, f"multihost: step {state.step}")
        check(not torch.distributed.is_initialized(),
              "multihost: the process group outlived main")
        check(got.get("gt_labels", 0) == n,
              f"multihost: gt_labels launched {got.get('gt_labels', 0)} "
              f"times in {n} iterations")
        check(got.get("roi_crop", 0) == calls.n > n,
              f"multihost: roi_crop launched {got.get('roi_crop', 0)} times "
              f"for {calls.n} preprocessed batches")
        check(got.get("min_dist2", 0) == 13,
              f"multihost: min_dist2 launched {got.get('min_dist2', 0)} "
              "times for 13 evaluated objects")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        print(f"multihost: main --multihost, group of one over NCCL, "
              f"{'resumed to ' if resume else ''}{epochs} epoch(s) of {n} "
              f"iterations with eval of lm_13_test: {wall:.2f} s of main, "
              f"ms/step {', '.join(f'{x:.2f}' for x in step_ms)} (median "
              f"{np.median(step_ms):.2f}; loader wait median "
              f"{1e3 * np.median(rec['waits']):.2f}), launches {got} for "
              f"{calls.n} preprocessed batches [{card}]")
    lines = [json.loads(ln) for ln in open(os.path.join(out,
                                                        "metrics.json"))]
    check([ln["iteration"] for ln in lines]
          == list(range(1, 2 * ITERS_PER_EPOCH + 1))
          and all(np.isfinite(ln["total_loss"]) for ln in lines),
          f"multihost: metrics.json {[ln['iteration'] for ln in lines]}")
    steps = sorted(int(d) for d in os.listdir(os.path.join(out, "ckpt")))
    check(steps == [ITERS_PER_EPOCH, 2 * ITERS_PER_EPOCH],
          f"multihost: checkpoints {steps}")
    ident, R, t = read_csv(os.path.join(out, "lm_13_test_bop19.csv"))
    check(len(ident) == 13 * EVAL_FRAMES_PER_OBJ
          and bool(np.isfinite(R).all() and np.isfinite(t).all()),
          f"multihost: {len(ident)} CSV rows")
    return launches


# phase 14: the other experiment configs and VSD --------------------------

def capture_evals():
    """Wraps ``eval_runner.run_eval`` to keep each result (``main``'s train
    branch drops them); returns (the results, a function that undoes it)."""
    from rdpn6d_tpu_torch.engine import eval_runner

    results: list = []
    orig = eval_runner.run_eval

    def recording(*a, **kw):
        results.append(orig(*a, **kw))
        return results[-1]

    eval_runner.run_eval = recording
    return results, lambda: setattr(eval_runner, "run_eval", orig)


def tree_visib(root: str, subdir: str) -> list[float]:
    """Every instance's ``visib_fract`` in the scenes under ``root/subdir``."""
    out = []
    for dirpath, _, files in sorted(os.walk(os.path.join(root, subdir))):
        if "scene_gt_info.json" in files:
            info = json.load(open(os.path.join(dirpath,
                                               "scene_gt_info.json")))
            out += [i["visib_fract"] for v in info.values() for i in v]
    return out


def train_bop(config, out, opts, pool):
    """``main`` (no ``--eval-only``) on one of the port's config files with
    the trainer instrumented, launches zeroed right before; returns (train
    state, launches, preprocessed batches, their frame sizes, the trainer's
    record, the eval results, wall s)."""
    import torch

    from rdpn6d_tpu_torch import main as port_main
    from rdpn6d_tpu_torch.ops import cuda_build

    rec: dict = {}
    undo = instrument_trainer(rec)
    results, undo_eval = capture_evals()
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    try:
        with PreprocessCalls() as calls:
            state = port_main.main(["--config-file", config, "--opts",
                                    *opts, f'data.bg_images_dir="{pool}"',
                                    f'train.output_dir="{out}"'])
    finally:
        undo()
        undo_eval()
    torch.cuda.synchronize()
    return (state, dict(cuda_build.LAUNCHES), calls, rec, results,
            time.perf_counter() - t0)


def check_train_lines(out: str, iters: int, label: str) -> None:
    lines = [json.loads(ln) for ln in open(os.path.join(out,
                                                        "metrics.json"))]
    check([ln["iteration"] for ln in lines] == list(range(1, iters + 1)),
          f"{label}: metrics.json iterations "
          f"{[ln['iteration'] for ln in lines]}")
    bad = [(ln["iteration"], k) for ln in lines for k, v in ln.items()
           if (k.startswith("loss") or k in ("total_loss", "grad_norm"))
           and not np.isfinite(v)]
    check(not bad, f"{label}: non-finite logged losses {bad[:5]}")


def run_bop_ycbv(dev, card, work):
    """Phase 14(a): ``main`` trains ``configs/ycbv.py`` at full width on a
    ycbv tree written under ``work/data14`` (real PNG frames with GT xyz
    crops, PBR JPEG frames, TRAIN2 0.5, the visib20 filter, the symmetric
    PM loss), then evaluates on ``ycbv_test``'s keyframes; returns the
    launches."""
    from rdpn6d_tpu_torch.config import load_config
    from rdpn6d_tpu_torch.data.loader import load_train_records
    from rdpn6d_tpu_torch.data.refs import YCBV
    from rdpn6d_tpu_torch.data.synthetic import write_bg_pool, write_bop_tree

    data = os.environ["RDPN6D_DATA_ROOT"]
    objs = {o: YCBV.obj2id[o] for o in YCBV.objects[:BOP_INSTS]}
    t0 = time.perf_counter()
    write_bop_tree(data, "ycbv", objs, YCBV_TRAIN_FRAMES, YCBV_PBR_FRAMES,
                   YCBV_TEST_FRAMES, BOP_INSTS, seed=14)
    pool = os.path.join(work, "VOC")
    if not os.path.isdir(pool):
        write_bg_pool(pool, seed=13)
    print(f"ycbv: wrote a YCB-V tree ({YCBV_TRAIN_FRAMES} real, "
          f"{YCBV_PBR_FRAMES} PBR JPEG and {YCBV_TEST_FRAMES} test frames of "
          f"{BOP_INSTS} occluding cubes and a hidden one, 21 models) in "
          f"{time.perf_counter() - t0:.1f} s (host, set-up)")
    config = os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "ycbv.py")
    out = os.path.join(work, "ycbv")
    opts = ["train.log_period=1", "train.checkpoint_period_epochs=1e9",
            f"solver.total_epochs={YCBV_EPOCHS}"]
    cfg = load_config(config, opts)
    d = cfg.data
    check(cfg.backbone.depth == 34 and cfg.head.num_regions == 32
          and cfg.data.input_res == 256 and cfg.head.out_res == 64
          and cfg.head.num_classes == 21 and cfg.loss.pm_loss_sym
          and d.filter_visib_thr == 0.2 and d.train2_ratio == 0.5
          and d.train2_datasets == ("ycbv_train_pbr",)
          and cfg.solver.ims_per_batch == TRAIN_ROIS,
          "phase 14(a) does not run ycbv's own settings")
    vf = tree_visib(os.path.join(data, "ycbv"), "train_real")
    n_records = len(load_train_records(cfg, list(d.train_datasets)))
    want = sum(v >= 0.2 for v in vf)
    check(n_records == want and want < len(vf),
          f"ycbv: {n_records} filtered records, {want} of the tree's "
          f"{len(vf)} instances at visib_fract >= 0.2")
    iters = n_records // TRAIN_ROIS * YCBV_EPOCHS
    rng = np.random.RandomState(cfg.train.seed)
    n_pbr = sum(rng.rand() < d.train2_ratio for _ in range(iters))
    opts.append(f"train.eval_period={iters}")
    state, launches, calls, rec, results, wall = train_bop(config, out,
                                                           opts, pool)
    check(state.step == iters and len(rec["stamps"]) == iters,
          f"ycbv: {len(rec['stamps'])} iterations to step {state.step}, "
          f"expected {iters}")
    check_train_lines(out, iters, "ycbv")
    check(0 < n_pbr < iters and launches.get("gt_labels", 0) == iters - n_pbr
          and launches.get("surface_labels", 0) == n_pbr,
          f"ycbv: label launches {launches} for {iters - n_pbr} real and "
          f"{n_pbr} PBR iterations")
    check(len(results) == 1, f"ycbv: {len(results)} evals")
    res = results[0]
    for row in [*res["per_obj"].values(), res["mean"]]:
        for k in ("AUCadd", "AUCadi", "AUCad", "ad_2", "ad_5", "ad_10",
                  "ABSad_2cm"):
            check(k in row and bool(np.isfinite(row[k])),
                  f"ycbv: column {k} missing or non-finite")
    targets = json.load(open(os.path.join(data, "ycbv",
                                          "test_targets_bop19.json")))
    n_objs = len({t["obj_id"] for t in targets})
    check(launches.get("min_dist2", 0) == n_objs == len(res["per_obj"]),
          f"ycbv: min_dist2 launched {launches.get('min_dist2', 0)} times "
          f"for {n_objs} evaluated objects")
    check(launches.get("roi_crop", 0) == calls.n > iters,
          f"ycbv: roi_crop launched {launches.get('roi_crop', 0)} times for "
          f"{calls.n} preprocessed batches")
    ident, R, t = read_csv(os.path.join(out, "ycbv_test_bop19.csv"))
    check(len(ident) == sum(x["inst_count"] for x in targets)
          and bool(np.isfinite(R).all() and np.isfinite(t).all()),
          f"ycbv: {len(ident)} CSV rows for {len(targets)} targets")
    step_ms = 1e3 * np.diff([rec["t0"]] + rec["stamps"])
    m = res["mean"]
    print(f"ycbv: ycbv full width bf16 autocast (21 classes, symmetric PM "
          f"loss, visib20: {n_records} of {len(vf)} real instances), "
          f"{iters} iterations ({n_pbr} on ycbv_train_pbr) and the eval of "
          f"{len(ident)} keyframe targets in {wall:.2f} s of main; ms/step "
          f"median {np.median(step_ms):.2f}; MEAN AUCadd {m['AUCadd']:.2f} "
          f"AUCadi {m['AUCadi']:.2f} AUCad {m['AUCad']:.2f} ad_10 "
          f"{m['ad_10']:.2f} ABSad_2cm {m['ABSad_2cm']:.2f} (seeded "
          f"weights); launches {launches} [{card}]")
    return launches


def labels_at(dev, card, H, W):
    """Phase 14(b)'s and 15(b)'s kernel checks at T-LESS's 540x720 and
    ITODD's 960x1280 frames, as phase 2 holds them at 480x640:
    ``roi_crop`` bit-equal at the train shape (24 ROIs of 8 frames, raw
    depth, not normalised) and an eval batch (32 ROIs, normalised),
    ``surface_labels`` bit-equal and ``gt_labels`` (masks equal, ids away
    from near-ties, coords within 1e-5) at 24 ROIs -> 64², K = 32.
    Returns each kernel's worst error."""
    import torch

    from rdpn6d_tpu_torch.ops.gt_labels import gt_labels, gt_labels_plain
    from rdpn6d_tpu_torch.ops.roi_crop import (
        roi_crop,
        roi_crop_plain,
        roi_crop_plan,
    )
    from rdpn6d_tpu_torch.ops.surface_labels import (
        surface_labels,
        surface_labels_plain,
    )
    from rdpn6d_tpu_torch.ops.warp import crop_resize_frames
    from rdpn6d_tpu_torch.ops import cuda_build

    o, K = GT_LABELS_OUT_RES, 32
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    worst = {"roi_crop": 0.0, "gt_labels": 0.0, "surface_labels": 0.0}
    for B, F, normalize in ((TRAIN_ROIS, 8, False), (32, 8, True)):
        args = roi_crop_inputs(B, F, H, W, B + 5, dev, "uint8", True, 256)
        got = roi_crop(*args, 256, 64, mean, std, normalize=normalize)
        ref = roi_crop_plain(*args, 256, 64, mean, std, normalize=normalize)
        torch.cuda.synchronize()
        check(same_bits(got[0], ref[0]) and same_bits(got[1], ref[1]),
              f"roi_crop differs from plain at {B} ROIs of {F} {H}x{W}")
        iters, blocks = roi_crop_plan(B, 256, cuda_build.sm_count(None))
        print(f"{H}x{W}: roi_crop {B} ROIs of {F} frames, raw depth, "
              f"normalize={normalize}: bit-equal to plain (plan {iters} "
              f"iterations x {blocks} blocks)")
    for masks in ("packed", "trunc"):
        inp = surface_label_inputs(TRAIN_ROIS, 8, H, W, K, 5, dev, masks)
        got = surface_labels(*inp, o)
        ref = surface_labels_plain(*inp, o)
        torch.cuda.synchronize()
        for k in ("roi_mask_visib", "roi_mask_obj", "roi_mask_trunc",
                  "roi_region"):
            check(torch.equal(got[k], ref[k]),
                  f"surface_labels {k} differs at {H}x{W} {masks}")
        err = float((got["roi_xyz"] - ref["roi_xyz"]).abs().max())
        check(err <= 1e-6, f"surface_labels coords {err:.3e} at {H}x{W}")
        worst["surface_labels"] = max(worst["surface_labels"], err)
        inp = gt_label_inputs(TRAIN_ROIS, H, W, K, 6, dev, masks, True)
        got = gt_labels(*inp, o)
        ref = gt_labels_plain(*inp, o)
        torch.cuda.synchronize()
        for k in ("roi_mask_visib", "roi_mask_obj", "roi_mask_trunc"):
            check(torch.equal(got[k], ref[k]),
                  f"gt_labels {k} differs at {H}x{W} {masks}")
        xyz_c = crop_resize_frames(inp[2].float(),
                                   torch.arange(TRAIN_ROIS, device=dev),
                                   inp[3], inp[4], o, interp="nearest")
        differ = got["roi_region"] != ref["roi_region"]
        check(not bool((differ & ~near_ties(xyz_c, inp[5])).any()),
              f"gt_labels ids disagree away from ties at {H}x{W}")
        err = float((got["roi_xyz"] - ref["roi_xyz"]).abs()[~differ].max())
        check(err <= 1e-5, f"gt_labels coords {err:.3e} at {H}x{W}")
        worst["gt_labels"] = max(worst["gt_labels"], err)
        print(f"{H}x{W}: surface_labels and gt_labels {TRAIN_ROIS} ROIs "
              f"->{o} K={K} {masks} masks: masks and ids equal to plain "
              f"(gt_labels ids: {int(differ.sum())} px at near-ties), coord "
              f"max_abs_err {err:.3e}")
    return worst


def host_ar(data, out, split, ref, cfg, targets):
    """The BOP19 AR recomputed on the host from the written CSV and the
    tree (records, eval meshes, targets), as ``run_eval`` scores it."""
    from rdpn6d_tpu_torch.data.assets import load_class_assets
    from rdpn6d_tpu_torch.data.bop import build_split_records, get_split
    from rdpn6d_tpu_torch.evaluation.bop_score import bop19_average_recalls

    ident, R, t = read_csv(os.path.join(out, f"{split}_bop19.csv"))
    ests = [{"scene_id": int(a), "im_id": int(b), "obj_id": int(c),
             "score": float(sc), "R": R[n].reshape(3, 3),
             "t": t[n] / 1000.0} for n, (a, b, c, sc) in enumerate(ident)]
    gts: dict = {}
    for r in build_split_records(get_split(split)):
        gts.setdefault((r["scene_id"], r["im_id"]), []).append(
            {"obj_id": r["obj_id"], "R": r["R"], "t": r["t"], "K": r["K"]})
    objs = sorted({ref.id2obj[x["obj_id"]] for x in targets})
    assets = load_class_assets(ref, cfg.head.num_regions,
                               cfg.loss.num_pm_points, objs=objs,
                               use_eval_models=True)

    def bank(k):
        return {o: assets.for_obj(o)[k] for o in assets.obj_ids}

    return bop19_average_recalls(
        ests, gts, targets, bank("points"), bank("sym_rots"),
        {o: float(assets.for_obj(o)["diameter"]) for o in assets.obj_ids},
        im_width=ref.width, sym_trans=bank("sym_trans"))


def run_bop_tless(dev, card, work):
    """Phase 14(b): the kernels at 540x720, then ``main`` trains
    ``configs/tless.py`` at full width on a T-LESS tree and evaluates on
    ``tless_bop_test``; returns (launches, each kernel's worst error at
    540x720)."""
    from rdpn6d_tpu_torch.config import load_config
    from rdpn6d_tpu_torch.data.loader import load_train_records
    from rdpn6d_tpu_torch.data.refs import TLESS
    from rdpn6d_tpu_torch.data.synthetic import write_bop_tree
    from rdpn6d_tpu_torch.evaluation import bop_score

    worst = labels_at(dev, card, 540, 720)
    data = os.environ["RDPN6D_DATA_ROOT"]
    objs = {o: TLESS.obj2id[o] for o in TLESS.objects[:BOP_INSTS]}
    t0 = time.perf_counter()
    write_bop_tree(data, "tless", objs, TLESS_TRAIN_FRAMES, 0,
                   TLESS_TEST_FRAMES, BOP_INSTS, seed=15)
    print(f"tless: wrote a T-LESS tree ({TLESS_TRAIN_FRAMES} train and "
          f"{TLESS_TEST_FRAMES} test 540x720 frames, 30 models) in "
          f"{time.perf_counter() - t0:.1f} s (host, set-up)")
    config = os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "tless.py")
    out = os.path.join(work, "tless")
    opts = ["train.log_period=1", "train.checkpoint_period_epochs=1e9",
            "solver.total_epochs=2"]
    cfg = load_config(config, opts)
    check(cfg.head.num_classes == 30 and cfg.backbone.depth == 34
          and cfg.head.num_regions == 32 and cfg.loss.pm_loss_sym
          and "mspd" in cfg.test.error_types,
          "phase 14(b) does not run tless's own settings")
    iters = len(load_train_records(cfg, list(cfg.data.train_datasets))) \
        // TRAIN_ROIS * 2
    opts.append(f"train.eval_period={iters}")
    widths: list = []
    ar = bop_score.bop19_average_recalls

    def ar_spy(*a, **kw):
        widths.append(kw.get("im_width"))
        return ar(*a, **kw)

    bop_score.bop19_average_recalls = ar_spy
    try:
        state, launches, calls, rec, results, wall = train_bop(
            config, out, opts, os.path.join(work, "VOC"))
    finally:
        bop_score.bop19_average_recalls = ar
    check(state.step == iters, f"tless: step {state.step}, expected {iters}")
    check_train_lines(out, iters, "tless")
    check(calls.sizes == {(540, 720)}, f"tless: frames of {calls.sizes}")
    check(launches.get("roi_crop", 0) == calls.n > iters
          and launches.get("gt_labels", 0) == iters
          and launches.get("surface_labels", 0) == 0,
          f"tless: launches {launches} for {iters} iterations and "
          f"{calls.n} preprocessed batches")
    cache = rec["cache"]
    per_frame = 540 * 720 * 5          # uint8 RGB and 16-bit raw depth
    check(cache is not None and len(cache) > 0
          and 0 <= cache.resident_bytes - len(cache) * per_frame
          < 256 * len(cache),
          f"tless: device cache {cache.resident_bytes if cache else 0} B "
          f"for {len(cache) if cache else 0} frames of 540x720")
    check(widths == [720], f"tless: MSPD scaled for widths {widths}")
    res = results[0]
    got = res["bop19"]
    check(set(got) == {"AR_mssd", "AR_mspd", "AR"}
          and got["AR"] == (got["AR_mssd"] + got["AR_mspd"]) / 2.0,
          f"tless: BOP19 AR {got}")
    targets = json.load(open(os.path.join(data, "tless",
                                          "test_targets_bop19.json")))
    again = host_ar(data, out, "tless_bop_test", TLESS, cfg, targets)
    check(all(abs(again[k] - got[k]) <= 1e-12 for k in got),
          f"tless: AR from the CSV {again} against the run's {got}")
    check(launches.get("min_dist2", 0) == len(res["per_obj"]),
          f"tless: min_dist2 launched {launches.get('min_dist2', 0)} times "
          f"for {len(res['per_obj'])} objects")
    step_ms = 1e3 * np.diff([rec["t0"]] + rec["stamps"])
    print(f"tless: tless full width bf16 autocast at 540x720 (30 classes), "
          f"{iters} iterations and the eval in {wall:.2f} s of main; "
          f"ms/step median {np.median(step_ms):.2f}; device cache "
          f"{len(cache)} frames, {cache.resident_bytes} B; MSPD thresholds "
          f"x720/640; BOP19 {got} (seeded weights), equal to the AR "
          f"recomputed from the CSV; launches {launches} [{card}]")
    return launches, worst


def run_mini_vsd(dev, card, work):
    """Phase 14(c): ``main --eval-only`` on ``configs/mini.py`` at full
    width over a mini tree (meshes with faces) with a seeded checkpoint:
    the BOP19 AR with VSD rendered on the host; returns the launches."""
    import torch

    from rdpn6d_tpu_torch import main as port_main
    from rdpn6d_tpu_torch.config import load_config
    from rdpn6d_tpu_torch.data.bop import build_split_records, get_split
    from rdpn6d_tpu_torch.data.synthetic import write_mini_tree
    from rdpn6d_tpu_torch.engine.checkpoint import CheckpointManager
    from rdpn6d_tpu_torch.evaluation import bop_score
    from rdpn6d_tpu_torch.models import RDPN, init_weights
    from rdpn6d_tpu_torch.ops import cuda_build, rasterizer
    from rdpn6d_tpu_torch.parallel import create_train_state

    data = os.environ["RDPN6D_DATA_ROOT"]
    t0 = time.perf_counter()
    write_mini_tree(data, n_train=2, n_test=MINI_TEST_FRAMES, seed=16)
    print(f"mini: wrote the mini tree ({MINI_TEST_FRAMES} test frames) in "
          f"{time.perf_counter() - t0:.1f} s (host, set-up)")
    config = os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "mini.py")
    out = os.path.join(work, "mini")
    cfg = load_config(config)
    check(cfg.backbone.depth == 34 and cfg.head.num_regions == 32
          and "vsd" in cfg.test.error_types.split(","),
          "phase 14(c) does not run mini's own settings")
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(17))
    with torch.no_grad():      # poses ~1 m away, as physical_z does
        model.pnp_net.fc_t.bias[2] = 2.0
    CheckpointManager(os.path.join(out, "ckpt")).save(
        0, create_train_state(cfg, model))

    renders, fns, vsd_s = [], [], [0.0]
    render, make = rasterizer.render_mesh, bop_score.make_vsd_error_fn

    def render_spy(v, f, K, R, t, H, W):
        t1 = time.perf_counter()
        d = render(v, f, K, R, t, H, W)
        renders.append(((np.asarray(R, np.float64).tobytes(),
                         np.asarray(t, np.float64).tobytes()),
                        time.perf_counter() - t1))
        return d

    def make_spy(*a, **kw):
        fn = make(*a, **kw)

        def timed(est, gt):
            t1 = time.perf_counter()
            e = fn(est, gt)
            vsd_s[0] += time.perf_counter() - t1
            return e

        timed.render_cache_info = fn.render_cache_info
        fns.append(timed)
        return timed

    rasterizer.render_mesh, bop_score.make_vsd_error_fn = render_spy, \
        make_spy
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    try:
        with PreprocessCalls() as calls:
            res = port_main.main(["--config-file", config, "--eval-only",
                                  "--opts", f'train.output_dir="{out}"'])
    finally:
        rasterizer.render_mesh, bop_score.make_vsd_error_fn = render, make
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_build.LAUNCHES)
    res = res["lm_mini_test"]
    ar = res["bop19"]
    check(set(ar) == {"AR_mssd", "AR_mspd", "AR_vsd", "AR"}
          and 0.0 <= ar["AR_vsd"] <= 1.0
          and abs(ar["AR"] - (ar["AR_vsd"] + ar["AR_mssd"]
                              + ar["AR_mspd"]) / 3.0) <= 1e-12,
          f"mini: BOP19 AR {ar}")
    check(len(fns) == 1, f"mini: {len(fns)} VSD error functions")
    info = fns[0].render_cache_info()
    poses = [p for p, _ in renders]
    targets = json.load(open(os.path.join(data, "lm",
                                          "test_targets_mini.json")))
    tset = {(x["scene_id"], x["im_id"], x["obj_id"]) for x in targets}
    gt_poses = {(np.asarray(r["R"], np.float64).tobytes(),
                 np.asarray(r["t"], np.float64).tobytes())
                for r in build_split_records(get_split("lm_mini_test"))
                if (r["scene_id"], r["im_id"], r["obj_id"]) in tset}
    check(info.misses == len(renders) and len(set(poses)) == len(poses)
          and gt_poses <= set(poses),
          f"mini: {len(renders)} renders ({len(set(poses))} distinct), "
          f"cache {info}, {len(gt_poses)} GT poses of targets")
    check(launches.get("min_dist2", 0) == len(res["per_obj"])
          and launches.get("roi_crop", 0) == calls.n > 0,
          f"mini: launches {launches} for {len(res['per_obj'])} objects and "
          f"{calls.n} batches")
    render_ms = 1e3 * np.array([s for _, s in renders])
    print(f"mini: mini full width bf16 main --eval-only on lm_mini_test "
          f"({len(targets)} targets) in {wall:.2f} s; BOP19 {ar} (seeded "
          f"weights); VSD on the host {vsd_s[0]:.3f} s: {len(renders)} "
          f"renders of 480x640 ({len(gt_poses)} GT poses, each once), "
          f"{np.median(render_ms):.3f} ms a render median, "
          f"{render_ms.max():.3f} max, cache {info}; launches {launches} "
          f"[{card}]")
    return launches


# phase 15: MP6D's ycb_style records, ITODD's TIFF frames, the flat path -----

MP6D_TRAIN_FRAMES = 6        # x 8 cubes: 48 records, 2 iterations
MP6D_TEST_FRAMES = 3
ITODD_PBR_FRAMES = 3         # in each of PBR scenes 0 and 49 (scene 0's
                             # first a JPEG, the rest PNG), 8 cubes and a
                             # hidden ninth: 54 records, 2 iterations
ITODD_VAL_FRAMES = 2         # gray TIFF (LZW, horizontal predictor)
FLAT_PARITY_ROIS = 4         # phase 15(c)'s card-vs-CPU step, as phase 7's


def train_and_score(config, out, opts, pool, label, iters):
    """``train_bop`` with phase 15's checks of a train run: the step, the
    metrics lines, the preprocessed batches (``roi_crop`` once each);
    returns train_bop's results."""
    got = train_bop(config, out, opts, pool)
    state, launches, calls, rec = got[:4]
    check(state.step == iters and len(rec["stamps"]) == iters,
          f"{label}: {len(rec['stamps'])} iterations to step {state.step}, "
          f"expected {iters}")
    check_train_lines(out, iters, label)
    check(launches.get("roi_crop", 0) == calls.n >= iters,
          f"{label}: roi_crop launched {launches.get('roi_crop', 0)} times "
          f"for {calls.n} preprocessed batches")
    return got


def eval_only(config, out, opts, split, debug=False):
    """``main --eval-only`` (``--debug``) with launches zeroed right
    before; returns (the split's result, launches, batches, wall s)."""
    import torch

    from rdpn6d_tpu_torch import main as port_main
    from rdpn6d_tpu_torch.ops import cuda_build

    torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    with PreprocessCalls() as calls:
        res = port_main.main(["--config-file", config, "--eval-only"]
                             + ["--debug"] * debug
                             + ["--opts", *opts, f'train.output_dir="{out}"'])
    torch.cuda.synchronize()
    return (res[split], dict(cuda_build.LAUNCHES), calls.n,
            time.perf_counter() - t0)


def check_scores(res, columns, label):
    for row in [*res["per_obj"].values(), res["mean"]]:
        for k in columns:
            check(k in row and bool(np.isfinite(row[k])),
                  f"{label}: column {k} missing or non-finite")


def add_launches(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def run_mp6d(dev, card, work):
    """Phase 15(a): ``main`` trains ``configs/mp6d.py`` at full width (20
    classes) one epoch on a ``ycb_style`` tree written under the data root
    (no xyz crops: labels from the depth surface under the label image's
    masks), then ``main --eval-only`` scores ``mp6d_test`` with
    AUCadd, AUCadi, AUCad and VSD asked for; returns the launches."""
    from rdpn6d_tpu_torch.config import load_config
    from rdpn6d_tpu_torch.data.loader import load_train_records
    from rdpn6d_tpu_torch.data.refs import MP6D
    from rdpn6d_tpu_torch.data.synthetic import write_mp6d_tree

    data = os.environ["RDPN6D_DATA_ROOT"]
    objs = {o: MP6D.obj2id[o] for o in MP6D.objects[:BOP_INSTS]}
    t0 = time.perf_counter()
    write_mp6d_tree(data, objs, MP6D_TRAIN_FRAMES, MP6D_TEST_FRAMES,
                    BOP_INSTS, seed=18)
    print(f"mp6d: wrote a ycb_style MP6D tree ({MP6D_TRAIN_FRAMES} train "
          f"and {MP6D_TEST_FRAMES} test frames of {BOP_INSTS} occluding "
          f"cubes, -meta.mat by scipy, 20 models) in "
          f"{time.perf_counter() - t0:.1f} s (host, set-up)")
    config = os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "mp6d.py")
    out = os.path.join(work, "mp6d")
    opts = ["train.log_period=1", "train.checkpoint_period_epochs=1",
            "solver.total_epochs=1", "train.eval_period=0"]
    cfg = load_config(config, opts)
    check(cfg.head.num_classes == 20 and cfg.backbone.depth == 34
          and cfg.head.num_regions == 32 and cfg.data.change_bg_prob == 0.5
          and cfg.data.truncate_fg and cfg.data.color_aug_prob == 0.8
          and cfg.test.error_types == "AUCadd,AUCadi,AUCad,vsd"
          and cfg.solver.ims_per_batch == TRAIN_ROIS,
          "phase 15(a) does not run mp6d's own settings")
    records = load_train_records(cfg, list(cfg.data.train_datasets))
    check(all(r["label_path"].endswith("-label.png") for r in records),
          "mp6d: records without their label image")
    iters = len(records) // TRAIN_ROIS
    state, launches, calls, rec, _, wall = train_and_score(
        config, out, opts, os.path.join(work, "VOC"), "mp6d", iters)
    check(launches.get("surface_labels", 0) == iters
          and launches.get("gt_labels", 0) == 0,
          f"mp6d: label launches {launches} in {iters} iterations")
    step_ms = 1e3 * np.diff([rec["t0"]] + rec["stamps"])
    print(f"mp6d: mp6d full width bf16 autocast (20 classes, label-image "
          f"masks, depth-surface labels), {len(records)} records, {iters} "
          f"iterations in {wall:.2f} s of main; ms/step median "
          f"{np.median(step_ms):.2f}; launches {launches} [{card}]")
    res, elaunch, batches, wall = eval_only(config, out, opts, "mp6d_test")
    check_scores(res, ("AUCadd", "AUCadi", "AUCad", "ad_10"), "mp6d")
    check(elaunch.get("min_dist2", 0) == len(res["per_obj"]) > 0
          and elaunch.get("roi_crop", 0) == batches > 0,
          f"mp6d eval: launches {elaunch} for {len(res['per_obj'])} "
          f"objects and {batches} batches")
    ident, R, t = read_csv(os.path.join(out, "mp6d_test_bop19.csv"))
    check(len(ident) == res["stats"]["n_rois"] > 0
          and bool(np.isfinite(R).all() and np.isfinite(t).all()),
          f"mp6d eval: {len(ident)} CSV rows for {res['stats']['n_rois']} "
          "ROIs")
    m = res["mean"]
    print(f"mp6d: main --eval-only on mp6d_test ({len(ident)} ROIs) in "
          f"{wall:.2f} s; MEAN AUCadd {m['AUCadd']:.2f} AUCadi "
          f"{m['AUCadi']:.2f} AUCad {m['AUCad']:.2f} (seeded weights; no "
          f"BOP19 targets, so no VSD AR); launches {elaunch} [{card}]")
    add_launches(launches, elaunch)
    return launches


def decode_ms(paths) -> float:
    """Median host ms of the port's ``imread_rgb`` over ``paths``."""
    from rdpn6d_tpu_torch.data.image import imread_rgb

    times = []
    for p in paths:
        t0 = time.perf_counter()
        imread_rgb(p)
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def run_itodd(dev, card, work):
    """Phase 15(b): the kernels at ITODD's 960x1280 frames, then ``main``
    trains ``configs/itodd.py`` at full width (28 classes) one epoch on
    PBR frames and evaluates the val scene read from gray TIFFs; returns
    (launches, each kernel's worst error at 960x1280)."""
    import glob

    from rdpn6d_tpu_torch.config import load_config
    from rdpn6d_tpu_torch.data.loader import load_train_records
    from rdpn6d_tpu_torch.data.refs import ITODD
    from rdpn6d_tpu_torch.data.synthetic import write_bop_tree

    worst = labels_at(dev, card, 960, 1280)
    data = os.environ["RDPN6D_DATA_ROOT"]
    objs = {o: ITODD.obj2id[o] for o in ITODD.objects[:BOP_INSTS]}
    t0 = time.perf_counter()
    write_bop_tree(data, "itodd", objs, 0, ITODD_PBR_FRAMES,
                   ITODD_VAL_FRAMES, BOP_INSTS, seed=19)
    ds = os.path.join(data, "itodd")
    tifs = sorted(glob.glob(os.path.join(ds, "val", "*", "gray", "*.tif")))
    jpgs = sorted(glob.glob(os.path.join(ds, "train_pbr", "*", "rgb",
                                         "*.jpg")))
    pngs = sorted(glob.glob(os.path.join(ds, "train_pbr", "*", "rgb",
                                         "*.png")))
    print(f"itodd: wrote an ITODD tree (PBR scenes 0 and 49 of "
          f"{ITODD_PBR_FRAMES} 960x1280 frames, {len(jpgs)} JPEG and "
          f"{len(pngs)} PNG; {len(tifs)} gray TIFF val frames; 28 models) "
          f"in {time.perf_counter() - t0:.1f} s (host, set-up)")
    check(len(tifs) == ITODD_VAL_FRAMES and len(jpgs) == 1 and pngs,
          f"itodd: {len(tifs)} TIFF, {len(jpgs)} JPEG, {len(pngs)} PNG")
    tif_ms, jpg_ms, png_ms = decode_ms(tifs), decode_ms(jpgs), \
        decode_ms(pngs)
    print(f"itodd: host decode of a 960x1280 frame, median: gray TIFF (LZW "
          f"+ predictor) {tif_ms:.2f} ms, JPEG {jpg_ms:.2f} ms, PNG "
          f"{png_ms:.2f} ms (one thread) [{card}]")
    config = os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "itodd.py")
    out = os.path.join(work, "itodd")
    opts = ["train.log_period=1", "train.checkpoint_period_epochs=1e9",
            "solver.total_epochs=1"]
    cfg = load_config(config, opts)
    check(cfg.head.num_classes == 28 and cfg.backbone.depth == 34
          and cfg.loss.pm_loss_sym and "adi" in cfg.test.error_types
          and cfg.data.train_datasets == ("itodd_pbr_train",),
          "phase 15(b) does not run itodd's own settings")
    iters = len(load_train_records(cfg, ["itodd_pbr_train"])) // TRAIN_ROIS
    opts.append(f"train.eval_period={iters}")
    state, launches, calls, rec, results, wall = train_and_score(
        config, out, opts, os.path.join(work, "VOC"), "itodd", iters)
    check(calls.sizes == {(960, 1280)}, f"itodd: frames of {calls.sizes}")
    check(launches.get("surface_labels", 0) == iters
          and launches.get("gt_labels", 0) == 0,
          f"itodd: label launches {launches} in {iters} iterations")
    cache = rec["cache"]
    per_frame = 960 * 1280 * 5         # uint8 RGB and 16-bit raw depth
    check(cache is not None and len(cache) > 0
          and 0 <= cache.resident_bytes - len(cache) * per_frame
          < 256 * len(cache),
          f"itodd: device cache {cache.resident_bytes if cache else 0} B "
          f"for {len(cache) if cache else 0} frames of 960x1280")
    check(len(results) == 1, f"itodd: {len(results)} evals")
    res = results[0]
    check_scores(res, ("ad_10", "adi_10", "AUCad", "re_2", "te_2"), "itodd")
    check(launches.get("min_dist2", 0) == len(res["per_obj"]) > 0,
          f"itodd: min_dist2 launched {launches.get('min_dist2', 0)} times "
          f"for {len(res['per_obj'])} objects")
    step_ms = 1e3 * np.diff([rec["t0"]] + rec["stamps"])
    wait_ms = 1e3 * np.asarray(rec["waits"])
    print(f"itodd: itodd full width bf16 autocast at 960x1280 (28 classes), "
          f"{iters} PBR iterations and the eval of {res['stats']['n_rois']} "
          f"val ROIs from gray TIFFs in {wall:.2f} s of main; ms/step "
          f"median {np.median(step_ms):.2f}, loader wait ms/step median "
          f"{np.median(wait_ms):.2f}; device cache {len(cache)} frames, "
          f"{cache.resident_bytes} B, "
          f"{cache.resident_bytes / len(cache):.0f} B a frame; launches "
          f"{launches} [{card}]")
    return launches, worst


def flat_config(amp: bool, out_dir: str, *extra):
    """lm13 at full width (``train_config``) on the flat path."""
    return train_config(amp, out_dir).apply_opts(
        ["data.grouped_train=false", *extra])


def flat_samples(cfg, n: int, seed: int) -> dict:
    """The flat loader's first batch of ``n`` samples of lm13's train
    splits (phases 9 and 10's trees)."""
    from rdpn6d_tpu_torch.data.loader import train_frame_iterator

    it = train_frame_iterator(cfg, list(cfg.data.train_datasets),
                              batch_size=n, seed=seed)
    try:
        return next(it)
    finally:
        it.close()


def flat_card_vs_cpu(dev, card, work):
    """Phase 15(c)'s first half: (i) the flat path's preprocessing
    (``preprocess_batch``, train mode, the test-time box) of 4 samples on
    the card and on the CPU, the crops bit-equal, the masks equal, ids
    away from near-ties and coordinates within 1e-5, then phase 7's step
    on each side's batch, to phase 7's bounds; (ii) ``gt_labels`` on a
    24-sample flat batch's float32 visib and trunc planes and float32
    full-frame xyz against its plain version, and its time there. Returns
    the worst coord error."""
    import torch

    from rdpn6d_tpu_torch.data.pipeline import preprocess_batch
    from rdpn6d_tpu_torch.ops.gt_labels import gt_labels, gt_labels_plain
    from rdpn6d_tpu_torch.ops.warp import crop_resize_frames

    cfg = flat_config(False, os.path.join(work, "flat_parity"),
                      'data.dzi_type="none"', "data.color_aug_prob=0.0",
                      "data.change_bg_prob=0.0")
    samples = flat_samples(cfg, FLAT_PARITY_ROIS, seed=20)
    batches = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        b = preprocess_batch(cfg, {k: torch.from_numpy(v).to(d)
                                   for k, v in samples.items()}, train=True)
        batches[name] = {k: v.to("cpu") for k, v in b.items()}
    c, p = batches["card"], batches["cpu"]
    check(same_bits(c["roi_img"], p["roi_img"])
          and same_bits(c["roi_coord_2d"], p["roi_coord_2d"]),
          "flat: roi_crop card vs CPU not bit-equal")
    for k in ("roi_mask_visib", "roi_mask_obj", "roi_mask_trunc"):
        check(torch.equal(c[k], p[k]), f"flat: {k} card vs CPU")
    differ = c["roi_region"] != p["roi_region"]
    check(float(differ.float().mean()) <= 1e-3,
          f"flat: region ids differ at {int(differ.sum())} px")
    err = float((c["roi_xyz"] - p["roi_xyz"]).abs()[~differ].max())
    check(err <= 1e-5, f"flat: coords card vs CPU {err:.3e}")
    print(f"flat: preprocess_batch of {FLAT_PARITY_ROIS} flat samples card "
          f"vs CPU: crops bit-equal, masks equal, ids differ at "
          f"{int(differ.sum())} px, coords max_abs_err {err:.3e}")
    train_parity(dev, work, batches={"card": c, "cpu": p},
                 label="flat train parity")

    cfg = flat_config(True, os.path.join(work, "flat_labels"),
                      'data.dzi_type="none"')
    s = flat_samples(cfg, TRAIN_ROIS, seed=21)
    t = {k: torch.from_numpy(v).to(dev) for k, v in s.items()}
    from rdpn6d_tpu_torch.data.pipeline import dzi_jitter

    center, scale = dzi_jitter(t["bbox"], (480, 640), "none",
                               cfg.data.dzi_pad_scale)
    o = GT_LABELS_OUT_RES
    inp = [t["mask_visib"], t["mask_trunc"], t["xyz"], center, scale,
           t["fps"], t["gt_rot"], t["extent"]]
    check(all(x.dtype == torch.float32 for x in inp[:3]),
          f"flat: the planes are {[x.dtype for x in inp[:3]]}")
    got = gt_labels(*inp, o)
    ref = gt_labels_plain(*inp, o)
    torch.cuda.synchronize()
    for k in ("roi_mask_visib", "roi_mask_obj", "roi_mask_trunc"):
        check(torch.equal(got[k], ref[k]), f"flat: gt_labels {k} differs")
    xyz_c = crop_resize_frames(inp[2], torch.arange(TRAIN_ROIS, device=dev),
                               center, scale, o, interp="nearest")
    differ = got["roi_region"] != ref["roi_region"]
    check(not bool((differ & ~near_ties(xyz_c, inp[5])).any()),
          "flat: gt_labels ids disagree away from ties")
    lerr = float((got["roi_xyz"] - ref["roi_xyz"]).abs()[~differ].max())
    check(lerr <= 1e-5, f"flat: gt_labels coords {lerr:.3e}")
    ms = device_ms(lambda: gt_labels(*inp, o), iters=100)
    # CUDA events: the profiler drops the records of the plain version's
    # larger kernels at this shape, as it did for a 2.3 ms min_dist2
    plain_ms = cuda_ms(lambda: gt_labels_plain(*inp, o), iters=5, warmup=1)
    pixels = TRAIN_ROIS * o * o
    # per output pixel its taps of two float32 masks and float32 xyz in,
    # 3 float32 masks, region and coord out
    bytes_ms = 1e3 * pixels * (4 + 4 + 12 + 3 * 4 + 4 + 12) \
        / HBM_BYTES_PER_S
    print(f"flat: gt_labels on the flat batch's float32 planes "
          f"({TRAIN_ROIS}x480x640 visib, trunc and xyz ->{o}, K=32): masks "
          f"equal to plain, ids differ at {int(differ.sum())} px (near-ties)"
          f", coord max_abs_err {lerr:.3e}; kernel {ms:.5f} ms device time, "
          f"plain {plain_ms:.4f} ms by CUDA events, bytes bound "
          f"{bytes_ms:.5f} ms [{card}]")
    return max(err, lerr)


def run_flat(dev, card, work, frames):
    """Phase 15(c): lm13 with ``data.grouped_train=false`` through
    ``main`` on phases 9 and 10's trees (one epoch from the flat loader,
    a checkpoint), ``main --eval-only --debug`` on that checkpoint, and
    ``Predictor(ckpt_dir=...)`` serving phase 3's frames from it; returns
    (launches, worst coord error of the checks)."""
    import torch

    from rdpn6d_tpu_torch.config import load_config
    from rdpn6d_tpu_torch.configs import lm13
    from rdpn6d_tpu_torch.engine.predictor import Predictor
    from rdpn6d_tpu_torch.ops import cuda_build

    os.environ["RDPN6D_DATA_ROOT"] = os.path.join(work, "data")
    worst = flat_card_vs_cpu(dev, card, work)
    config = os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "lm13.py")
    out = os.path.join(work, "flat")
    opts = ["data.grouped_train=false", "train.log_period=1",
            "train.checkpoint_period_epochs=1", "solver.total_epochs=1",
            "train.eval_period=0"]
    cfg = load_config(config, opts)
    check(not cfg.data.grouped_train and cfg.solver.amp
          and cfg.solver.ims_per_batch == TRAIN_ROIS,
          "phase 15(c) does not run lm13's flat settings")
    state, launches, calls, rec, _, wall = train_and_score(
        config, out, opts, os.path.join(work, "VOC"), "flat",
        ITERS_PER_EPOCH)
    check(rec["cache"] is None, "flat: a device frame cache on the flat path")
    check(launches.get("gt_labels", 0) == ITERS_PER_EPOCH
          and launches.get("surface_labels", 0) == 0,
          f"flat: label launches {launches}")
    check(calls.sizes == {(480, 640)}, f"flat: frames of {calls.sizes}")
    step_ms = 1e3 * np.diff([rec["t0"]] + rec["stamps"])
    wait_ms = 1e3 * np.asarray(rec["waits"])
    print(f"flat: lm13 full width bf16 autocast on the flat path "
          f"(data.grouped_train=false, {TRAIN_ROIS} full float32 frames a "
          f"step, no device cache): {ITERS_PER_EPOCH} iterations in "
          f"{wall:.2f} s of main; ms/step median {np.median(step_ms):.2f}, "
          f"loader wait ms/step median {np.median(wait_ms):.2f}; launches "
          f"{launches} [{card}]")
    # one object's test split: the debug eval decodes on one host thread
    res, dlaunch, batches, dwall = eval_only(
        config, out, opts + ['data.test_datasets=["lm_ape_test"]'],
        "lm_ape_test", debug=True)
    n_test = EVAL_FRAMES_PER_OBJ
    check(res["n"] == n_test and bool(np.isfinite(res["coord_l1"])),
          f"flat: --debug scored {res['n']} of {n_test}, L1 "
          f"{res['coord_l1']}")
    check(dlaunch.get("roi_crop", 0) == dlaunch.get("gt_labels", 0)
          == batches == -(-n_test // 16),
          f"flat: --debug launches {dlaunch} for {batches} batches")
    print(f"flat: main --eval-only --debug on lm_ape_test: masked coord L1 "
          f"{res['coord_l1']:.5f} over {res['n']} instances in {dwall:.2f} "
          f"s; launches {dlaunch} [{card}]")
    add_launches(launches, dlaunch)

    cfg = lm13.get_config().apply_opts(['head.init="fan_in"'])
    assets = lm_assets(cfg.head.num_regions, 4096, seed=1)
    served = Predictor(cfg, assets, ckpt_dir=os.path.join(out, "ckpt"),
                       batch_size=16, dtype=torch.float32, device="cuda")
    trained = state.model.state_dict()
    check(all(torch.equal(v, trained[k].float())
              for k, v in served.model.state_dict().items()),
          "flat: Predictor(ckpt_dir) holds other weights than the trained "
          "model's")
    ref = Predictor(cfg, assets, batch_size=16, dtype=torch.float32,
                    device="cuda", allow_random_init=True)
    ref.model.load_state_dict(trained)
    # 6 steps from a seeded init leave objects millimetres away, where t's
    # relative error means nothing: both at ~1 m, as phase 5 compares
    physical_z(served)
    physical_z(ref)
    cuda_build.reset_launches()
    with PreprocessCalls() as pcalls:
        outs, secs = serve(served, frames)
    plaunch = dict(cuda_build.LAUNCHES)
    ref_outs, _ = serve(ref, frames)
    flat_out = [r for o in outs for r in o]
    flat_ref = [r for o in ref_outs for r in o]
    n_det = sum(len(f[2]) for f in frames)
    dR = max(float(np.abs(a["R"] - b["R"]).max())
             for a, b in zip(flat_out, flat_ref))
    dt = max(float(np.abs(a["t"] - b["t"]).max() / np.abs(b["t"]).max())
             for a, b in zip(flat_out, flat_ref))
    # the same weights on the same card, but not bit for bit (an H100
    # gave |dR| of 2.6e-06 to 4.4e-06): the bound is phase 5's
    check(len(flat_out) == n_det == len(flat_ref) and dR <= 1e-3
          and dt <= 1e-3, f"flat: Predictor(ckpt_dir) poses differ from "
          f"the trained model's: max |dR| {dR:.3e}, max |dt|/|t| {dt:.3e}")
    check(plaunch.get("roi_crop", 0) == pcalls.n > 0,
          f"flat: Predictor launches {plaunch} for {pcalls.n} batches")
    print(f"flat: Predictor(ckpt_dir=...) served {n_det} poses of "
          f"{len(frames)} frames from main's checkpoint in "
          f"{secs * 1e3:.1f} ms (f32), its weights the trained model's, "
          f"tensor for tensor; poses (z moved to ~1 m on both) against the "
          f"trained model's on the card: max |dR| {dR:.3e}, max |dt|/|t| "
          f"{dt:.3e}; launches "
          f"{plaunch} [{card}]")
    add_launches(launches, plaunch)
    return launches, worst


# phase 16: test.use_pnp's RANSAC-Kabsch refinement and the model variants
# on an H100 SXM the 4096-point batches take clusters of 16, 8, 4, 2 and 2
# blocks a ROI: every size the served and eval batches give the kernel
RANSAC_SHAPES = [(1, 4096), (8, 4096), (16, 4096), (32, 4096), (64, 4096),
                 (3, 100), (2, 4097)]
RANSAC_THR = 0.015          # refine_pose_kabsch's inlier threshold
RANSAC_TOL = 1e-4           # kernel vs plain, R and t, where the best agrees
# ~20 FP32 operations a (hypothesis, point) pair: 9 multiply-adds of
# R m + t - c (an FMA counted as 2, 18), the 3 squares' sum and the compare
RANSAC_OPS_PER_PAIR = 20
FP32_FLOP_PER_S = 67e12
RANSAC_BATCH = 16           # the served batch (phase 3's batch size)
# timed: a served frame's detections, the served batch, an eval batch
RANSAC_TIMED = (6, RANSAC_BATCH, 32)
VARIANTS = {
    "s2d stem": ["backbone.space_to_depth=true"],
    "r_only TransHead": ["pnp.r_only=true"],
    "SimplePointPnP": ['pnp.pnp_head="SimplePointPnP"'],
    "PointPnP": ['pnp.pnp_head="PointPnP"'],
}


def ransac_bound(B: int, N: int, H: int) -> tuple[float, str]:
    """Least ms the card could take for the fit of B ROIs of N points and
    H hypotheses: the scoring's operations, or each input read once (N
    points of xyz, xyz and mask, the uniforms) and the outputs written
    once, the larger."""
    ops_s = B * H * N * RANSAC_OPS_PER_PAIR / FP32_FLOP_PER_S
    bytes_s = (B * N * 7 + B * H * 4 + B * 15) * 4 / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), \
        "operations" if ops_s >= bytes_s else "bytes"


def ransac_inputs(B, N, seed, dev, special=True):
    """Correspondences of a known pose per ROI (mm noise), outliers moved
    by ~10 cm at 0%, 30% and 60% in turn, 85% of the mask set, and the
    hypotheses' uniforms; with ``special`` and B >= 3 the last ROI is
    all masked out, the one before has 3 valid points and the one before
    that a NaN point. Returns the 4 inputs on ``dev``, R and t."""
    import torch

    from rdpn6d_tpu_torch.ops.ransac_kabsch import NUM_HYPS, SAMPLE_SIZE

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
    u = rng.rand(B, NUM_HYPS, SAMPLE_SIZE)

    def to(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    return (to(m), to(c), to(mask), to(u)), R, t


def ransac_compare(got, ref, mask, label, tol=RANSAC_TOL):
    """The kernel's fit against the plain version's: where the best
    hypothesis agrees, the same score and ratio and R, t within ``tol``
    (a ROI with no valid point has a zero covariance, whose rotation is
    any: there both R orthonormal and t equal); where it does not (a d2
    within rounding of the threshold counted on one side), the scores
    within 1 and the two refits within 1e-2. NaN patterns equal. Returns
    (worst error where the best agrees, ROIs whose best differs)."""
    import torch

    g = [x.cpu() for x in got]
    r = [x.cpu() for x in ref]
    check(torch.equal(g[0].isnan(), r[0].isnan())
          and torch.equal(g[1].isnan(), r[1].isnan()),
          f"{label}: the kernel's NaN pattern differs from plain's")
    empty = (mask.cpu().sum(-1) == 0)
    worst, flips = 0.0, []
    for i in range(g[0].shape[0]):
        if int(g[3][i]) != int(r[3][i]):
            flips.append(i)
            d = max(float((g[0][i] - r[0][i]).abs().max()),
                    float((g[1][i] - r[1][i]).abs().max()))
            check(abs(int(g[4][i]) - int(r[4][i])) <= 1 and d <= 1e-2,
                  f"{label}: ROI {i}: best {int(g[3][i])} (score "
                  f"{int(g[4][i])}) vs plain {int(r[3][i])} (score "
                  f"{int(r[4][i])}), fits {d:.3e} apart")
            continue
        check(int(g[4][i]) == int(r[4][i])
              and float(g[2][i]) == float(r[2][i]),
              f"{label}: ROI {i}: score/ratio {int(g[4][i])}/"
              f"{float(g[2][i])} vs plain {int(r[4][i])}/{float(r[2][i])}")
        if bool(r[0][i].isnan().any()):
            continue
        if bool(empty[i]):
            eye = torch.eye(3)
            for R in (g[0][i], r[0][i]):
                check(float((R @ R.T - eye).abs().max()) <= 1e-5
                      and abs(float(torch.linalg.det(R)) - 1) <= 1e-5,
                      f"{label}: ROI {i} (no valid point): R not a "
                      "rotation")
            check(float((g[1][i] - r[1][i]).abs().max()) <= tol,
                  f"{label}: ROI {i} (no valid point): t differs")
            continue
        d = max(float((g[0][i] - r[0][i]).abs().max()),
                float((g[1][i] - r[1][i]).abs().max()))
        check(d <= tol, f"{label}: ROI {i}: R, t {d:.3e} from plain "
              f"(tol {tol})")
        worst = max(worst, d)
    return worst, flips


def check_ransac_kabsch(dev, card):
    """Phase 16(a): ``ransac_kabsch`` against its plain version on the
    card at every shape of ``RANSAC_SHAPES``, then timed at each batch of
    ``RANSAC_TIMED`` beside its bound (the served batch also beside the
    plain version); returns (max error, times: the served batch's for the
    kernels line, each batch's ms and cluster)."""
    import torch

    from rdpn6d_tpu_torch.ops import cuda_build
    from rdpn6d_tpu_torch.ops.ransac_kabsch import (
        NUM_HYPS,
        SAMPLE_SIZE,
        cluster_blocks,
        cluster_sizes,
        cluster_slots,
        ransac_kabsch,
        ransac_kabsch_plain,
    )

    slots = cluster_slots(torch.cuda.current_device())
    worst = 0.0
    for i, (B, N) in enumerate(RANSAC_SHAPES):
        args, R_true, t_true = ransac_inputs(B, N, 40 + i, dev)
        C = cluster_blocks(B, slots, cluster_sizes(N, NUM_HYPS, SAMPLE_SIZE))
        got = ransac_kabsch(*args, RANSAC_THR)
        ref = ransac_kabsch_plain(*args, RANSAC_THR)
        torch.cuda.synchronize()
        err, flips = ransac_compare(got, ref, args[2],
                                    f"ransac_kabsch B={B} N={N}")
        worst = max(worst, err)
        R = got.R.cpu().numpy()
        ok = np.isfinite(R).all((1, 2))
        dR = np.abs(R - R_true).max((1, 2))
        good = ok & (dR <= 1e-2)
        print(f"kernel: ransac_kabsch B={B} N={N} H={NUM_HYPS} (a cluster "
              f"of {C} blocks a ROI): R, t within "
              f"{err:.3e} of plain where the best hypothesis agrees "
              f"({B - len(flips)} of {B} ROIs; differing: {flips}), NaN "
              f"patterns equal; {int(good.sum())} of {B} refits within "
              f"1e-2 of the true R; ratios "
              f"{np.round(got.ratio.cpu().numpy()[:6], 4).tolist()}")
    _, built = cuda_build.load("ransac_kabsch")
    usage = {k: v for k, v in cuda_build.ptxas_usage(built.log).items()
             if "ransac" in k}
    regs = ", ".join(f"{v['registers']} registers, {v['spill_stores']} B "
                     f"spill stores, {v['spill_loads']} B spill loads"
                     for v in usage.values())
    sms = cuda_build.sm_count(torch.cuda.current_device())
    print(f"kernel: ransac_kabsch: clusters the card holds at one block an "
          f"SM, by blocks a cluster: {slots} [{card}]")
    times = {}
    for B in RANSAC_TIMED:
        args, _, _ = ransac_inputs(B, 4096, 50, dev, special=False)

        def kernel():
            ransac_kabsch(*args, RANSAC_THR)

        ms = queued_ms(kernel, iters=50)
        bound_ms, bound_by = ransac_bound(B, 4096, NUM_HYPS)
        C = cluster_blocks(B, slots, cluster_sizes(4096, NUM_HYPS,
                                                   SAMPLE_SIZE))
        what = (f"device time (queued) {ms:.4f} ms, {100 * bound_ms / ms:.1f}"
                f"% of bound {bound_ms:.5f} ms ({bound_by}); a cluster of "
                f"{C} blocks a ROI, {B * C} blocks for the card's {sms} "
                "SMs")
        if B == RANSAC_BATCH:
            def plain():
                ransac_kabsch_plain(*args, RANSAC_THR)

            events_ms = cuda_ms(kernel, iters=50)
            plain_ms = cuda_ms(plain, iters=5, warmup=1)
            times.update(ms=ms, events_ms=events_ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bound_ms,
                         bound_by=bound_by)
            what += (f" (CUDA events over a burst {events_ms:.4f} ms), plain "
                     f"{plain_ms:.4f} ms; no single PyTorch call computes it")
        times[f"b{B}_ms"] = ms
        times[f"b{B}_cluster"] = C
        print(f"kernel: ransac_kabsch {B} ROIs x 4096 points x {NUM_HYPS} "
              f"hypotheses: {what}; {regs} [{card}]")
    return worst, times


class RansacCalls:
    """Records each ``ops.ransac_kabsch.ransac_kabsch`` call that
    ``refine_pose_kabsch`` makes inside a ``with`` block: its inputs and
    its pre-fallback fit."""

    def __enter__(self):
        from rdpn6d_tpu_torch.ops import ransac_kabsch as rk

        self.rk, self._orig, self.calls = rk, rk.ransac_kabsch, []

        def spy(*args, **kw):
            out = self._orig(*args, **kw)
            self.calls.append((args, out))
            return out

        rk.ransac_kabsch = spy
        return self

    def __exit__(self, *exc):
        self.rk.ransac_kabsch = self._orig
        return False

    def refined(self) -> tuple[int, int]:
        """(ROIs whose refit stands, ROIs fitted)."""
        from rdpn6d_tpu_torch.ops.ransac_kabsch import REFINE_MIN_RATIO

        ratios = [float(r) for _, out in self.calls for r in out.ratio]
        return sum(r > REFINE_MIN_RATIO for r in ratios), len(ratios)


def run_ransac_serving(dev, card, cfg, assets, frames):
    """Phase 16(b): lm13 at full width with ``test.use_pnp=true`` through
    ``Predictor`` in bf16 and f32 on phase 3's frames: one
    ``ransac_kabsch`` launch a served batch, finite poses, the refined
    ROIs counted; the f32 fits against the plain version on the card's
    own inputs, and the card's served pass against the CPU's on frame 0
    (the same weights and draws); returns the launches."""
    import torch

    from rdpn6d_tpu_torch.engine.predictor import Predictor
    from rdpn6d_tpu_torch.ops import cuda_build
    from rdpn6d_tpu_torch.ops.ransac_kabsch import ransac_kabsch_plain

    cfg = cfg.apply_opts(["test.use_pnp=true"])
    n_det = sum(len(f[2]) for f in frames)
    batches = sum(-(-len(f[2]) // SERVE_BATCH) for f in frames)
    total: dict = {}
    fits = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        pred = physical_z(Predictor(cfg, assets, batch_size=SERVE_BATCH,
                                    dtype=dt, device="cuda",
                                    allow_random_init=True))
        serve(pred, frames)                      # warm-up
        cuda_build.reset_launches()
        with RansacCalls() as rc, PreprocessCalls() as calls:
            outs, secs = serve(pred, frames)
        got = dict(cuda_build.LAUNCHES)
        flat = [r for o in outs for r in o]
        check(len(flat) == n_det and all(
            np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all()
            for r in flat), f"use_pnp {name}: missing or non-finite poses")
        check(got.get("ransac_kabsch", 0) == batches == calls.n
              and got.get("roi_crop", 0) == batches,
              f"use_pnp {name}: launches {got} for {batches} served "
              "batches")
        refined, fitted = rc.refined()
        print(f"serve: lm13 full width {name}, test.use_pnp: {n_det} poses "
              f"of {len(frames)} frames in {secs * 1e3:.1f} ms = "
              f"{n_det / secs:.1f} poses/s; ransac_kabsch x"
              f"{got.get('ransac_kabsch', 0)} in {batches} served batches; "
              f"{refined} of {fitted} ROIs refined (ratio > 0.05; seeded "
              f"weights) [{card}]")
        add_launches(total, got)
        fits[name] = (pred, rc.calls)
    # the kernel on the served pass's own inputs against the plain version
    worst, flips = 0.0, 0
    for args, out in fits["f32"][1]:
        ref = ransac_kabsch_plain(*args)
        torch.cuda.synchronize()
        err, f = ransac_compare(out, ref, args[2], "use_pnp f32 served fit")
        worst, flips = max(worst, err), flips + len(f)
    # the card's served pass against the CPU's, frame 0, the same draws
    cpu = physical_z(Predictor(cfg, assets, batch_size=SERVE_BATCH,
                               dtype=torch.float32, device="cpu",
                               allow_random_init=True))
    rgb, depth, dets = frames[0]
    with RansacCalls() as rc_cpu:
        cpu_out = cpu.predict(rgb, depth, K_LM, dets)
    with RansacCalls() as rc_card:
        card_out = fits["f32"][0].predict(rgb, depth, K_LM, dets)
    (c_args, c_fit), = rc_card.calls
    (p_args, p_fit), = rc_cpu.calls
    masks_equal = (c_args[2].cpu() == p_args[2]).all(-1).numpy()
    same = (c_fit.best.cpu() == p_fit.best).numpy() & masks_equal
    mask_agree = float((c_args[2].cpu() == p_args[2]).float().mean())
    dR_fit = max([float((c_fit.R[i].cpu() - p_fit.R[i]).abs().max())
                  for i in np.flatnonzero(same)] or [0.0])
    dR = max(float(np.abs(a["R"] - b["R"]).max())
             for a, b in zip(card_out, cpu_out))
    dt = max(float(np.abs(a["t"] - b["t"]).max() / np.abs(b["t"]).max())
             for a, b in zip(card_out, cpu_out))
    # phase 5's bounds, where the two sides' (float32, differently summed)
    # network outputs gave the same valid mask and the same best hypothesis
    check(dR_fit <= 1e-3, f"use_pnp f32: pre-fallback R card vs CPU "
          f"{dR_fit:.3e} where the best hypothesis agrees")
    print(f"serve: use_pnp f32 fits: kernel vs plain on the card's inputs "
          f"within {worst:.3e} where the best hypothesis agrees ({flips} "
          f"differ); card vs CPU on frame 0's {len(dets)} ROIs: masks agree "
          f"on {100 * mask_agree:.3f}% of points, masks and best "
          f"hypothesis equal on {int(same.sum())}, pre-fallback R within "
          f"{dR_fit:.3e} there; "
          f"served poses max |dR| {dR:.3e}, max |dt|/|t| {dt:.3e} [{card}]")
    return total


def run_ransac_eval(dev, card, work, bf16_mean):
    """Phase 16(c): ``main --eval-only`` with ``test.use_pnp=true`` on
    phase 9's tree and checkpoint: one ``ransac_kabsch`` launch an eval
    batch, ``min_dist2`` one an object; each batch's cluster size (the
    last batch is short) and its fits against the plain version on its
    own inputs, NaN patterns equal and the rest reported; returns the
    launches."""
    import torch

    from rdpn6d_tpu_torch import main as port_main
    from rdpn6d_tpu_torch.ops import cuda_build
    from rdpn6d_tpu_torch.ops.ransac_kabsch import (
        NUM_HYPS,
        SAMPLE_SIZE,
        cluster_blocks,
        cluster_sizes,
        cluster_slots,
        ransac_kabsch_plain,
    )

    os.environ["RDPN6D_DATA_ROOT"] = os.path.join(work, "data")
    out = os.path.join(work, "out_pnp")
    os.makedirs(out)
    os.symlink(os.path.join(work, "out", "ckpt"), os.path.join(out, "ckpt"))
    n_rois = 13 * EVAL_FRAMES_PER_OBJ
    n_batches = -(-n_rois // 32)
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    with RansacCalls() as rc, PreprocessCalls() as calls:
        res = port_main.main([
            "--config-file",
            os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "lm13.py"),
            "--eval-only", "--opts", f'train.output_dir="{out}"',
            "test.use_pnp=true"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(cuda_build.LAUNCHES)
    res = res["lm_13_test"]
    check(got.get("ransac_kabsch", 0) == n_batches == calls.n
          and got.get("roi_crop", 0) == n_batches
          and got.get("min_dist2", 0) == 13,
          f"use_pnp eval launches {got}, want ransac_kabsch and roi_crop "
          f"{n_batches}, min_dist2 13")
    ident, R, t = read_csv(os.path.join(out, "lm_13_test_bop19.csv"))
    check(len(ident) == n_rois and bool(np.isfinite(R).all()
                                        and np.isfinite(t).all()),
          "use_pnp eval: missing or non-finite poses in the CSV")
    refined, fitted = rc.refined()
    # the main path's own fits against the plain version, reported: the
    # seeded net decodes most ROIs' inliers to one or two model points,
    # where the refit's rotation is not unique and a d2 at thr^2 may round
    # to either side; 16(a) holds these cluster sizes to plain on posed data
    slots = cluster_slots(torch.cuda.current_device())
    sizes, agree = [], np.zeros(4, int)  # ROIs, best, score, R and t equal
    for args, fit in rc.calls:
        B, N = args[2].shape
        C = cluster_blocks(B, slots, cluster_sizes(N, NUM_HYPS, SAMPLE_SIZE))
        sizes.append(f"{B} ROIs: {C}")
        g = [x.cpu() for x in fit]
        r = [x.cpu() for x in ransac_kabsch_plain(*args)]
        check(torch.equal(g[0].isnan(), r[0].isnan()),
              "use_pnp eval: the kernel's NaN pattern differs from plain's")
        d = torch.maximum((g[0] - r[0]).abs().flatten(1).amax(1),
                          (g[1] - r[1]).abs().amax(1))
        agree += [B, int((g[3] == r[3]).sum()), int((g[4] == r[4]).sum()),
                  int((d <= RANSAC_TOL).sum())]
    st = res["stats"]
    keys = [k for k in ("ad_2", "ad_5", "ad_10", "adi_10", "re_5", "te_5",
                        "proj_5") if k in res["mean"]]
    table = ", ".join(f"{k} {res['mean'][k]:.2f} (phase 9 "
                      f"{bf16_mean[k]:.2f})" for k in keys)
    rate = st["n_timed"] / st["wall_s"] if st["wall_s"] else 0.0
    print(f"eval: lm13 full width bf16 main --eval-only test.use_pnp on "
          f"lm_13_test: {st['n_rois']} ROIs, {rate:.1f} poses/s past "
          f"warm-up, split "
          f"wall time {wall:.2f} s; {refined} of {fitted} ROIs refined; "
          f"blocks a ROI by batch: {', '.join(sizes)}; against plain on "
          f"these inputs (reported, not gated) best hypothesis equal on "
          f"{agree[1]} of {agree[0]} ROIs, score on {agree[2]}, R and t "
          f"within {RANSAC_TOL} on {agree[3]}; "
          f"MEAN {table} (seeded weights: reported, not gated); launches "
          f"{got} [{card}]")
    return got


def variant_forward(dev, card, work, name, opts):
    """Phase 16(d), one variant: its f32 forward on 4 preprocessed ROIs
    on the card and on the CPU (the same weights, TF32 off) within phase
    5's bounds, then phase 7's f32 train step card vs CPU."""
    import torch

    from rdpn6d_tpu_torch.data.pipeline import preprocess_rois_grouped
    from rdpn6d_tpu_torch.models import RDPN, init_weights

    cfg = train_config(amp=False, out_dir=os.path.join(work, "phase16")
                       ).apply_opts(opts)

    def physical(model):     # objects ~1 m away, as physical_z does
        with torch.no_grad():
            if cfg.pnp.r_only:
                model.trans_head_net.linears[4].bias[2] = 2.0
            else:
                model.pnp_net.fc_t.bias[2] = 2.0

    frames, rois = train_inputs(cfg, 31, 2, 2)
    batch = preprocess_rois_grouped(
        cfg, {k: torch.from_numpy(v) for k, v in frames.items()},
        {k: torch.from_numpy(v) for k, v in rois.items()})
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(2))
    physical(model)
    model.eval()
    outs = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        m = copy.deepcopy(model).to(d)
        with torch.no_grad():
            o = m({k: v.to(d) for k, v in batch.items()})
        outs[side] = {k: o[k].cpu().numpy() for k in ("rot_ego", "trans")}
    dR = float(np.abs(outs["card"]["rot_ego"] - outs["cpu"]["rot_ego"]).max())
    dt = float((np.abs(outs["card"]["trans"] - outs["cpu"]["trans"]).max(1)
                / np.abs(outs["cpu"]["trans"]).max(1)).max())
    check(np.isfinite(outs["card"]["rot_ego"]).all() and dR <= 1e-3
          and dt <= 1e-3, f"{name}: f32 forward card vs CPU |dR| {dR:.3e}, "
          f"|dt|/|t| {dt:.3e}")
    print(f"variants: {name} at lm13 full width, f32 forward of 4 ROIs card "
          f"vs CPU: max |dR| {dR:.3e}, max |dt|/|t| {dt:.3e} (tol 1e-3) "
          f"[{card}]")
    train_parity(dev, work, label=f"variants: {name} train step", opts=opts,
                 prepare=physical)


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
    kernels = ["min_dist2", "region_label", "int8_conv", "roi_crop",
               "ransac_kabsch"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; from rdpn6d_tpu_torch.ops "
         f"import cuda_build; cuda_build.build({k!r})"], cwd=ROOT)
        for k in kernels]
    # VSD's host rasterizer (host C++, not a kernel), beside them
    host = subprocess.Popen(
        [sys.executable, "-c", "from rdpn6d_tpu_torch.ops import "
         "cuda_build; cuda_build.build_host('rasterizer')"], cwd=ROOT)
    for k, p in zip(kernels + ["rasterizer"], procs + [host]):
        check(p.wait(timeout=900) == 0, f"build of {k} failed")
    for k in kernels:
        _, built = cuda_build.load(k)
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build: {k} -> {os.path.relpath(built.path, ROOT)}; "
              + " | ".join(ptxas))
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(kernels)} "
          "kernel(s) and the host rasterizer ("
          f"{os.path.relpath(cuda_build.build_host('rasterizer').path, ROOT)}"
          ")")

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
    crop_err, crop_times = check_roi_crop(dev, card)

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
    calls = PreprocessCalls()
    for name in ("bf16", "f32"):
        with calls:
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

    serve_batches = 2 * sum(-(-len(f[2]) // SERVE_BATCH) for f in frames)
    crop_launches = cuda_build.LAUNCHES.get("roi_crop", 0)
    check(crop_launches == calls.n == serve_batches,
          f"roi_crop launched {crop_launches} times for {calls.n} "
          f"preprocessed batches ({serve_batches} served batches)")
    print(f"serve: roi_crop x{crop_launches} in {serve_batches} served "
          "batches")

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
        fused_err, fused_times = check_bn_relu_quantize(dev, card)
        serve8 = run_int8_serving(dev, card, cfg, assets, frames,
                                  preds["bf16"], args.profile)
        eval8 = run_int8_eval(dev, card, work, bf16_mean)

        # 13. data parallelism -------------------------------------------
        dist_launches = run_dist_ranks(dev, card, work)
        mh_launches = run_multihost_cli(dev, card, work)

        # 14. the other configs and VSD ----------------------------------
        os.environ["RDPN6D_DATA_ROOT"] = os.path.join(work, "data14")
        t14 = time.perf_counter()
        ycbv_launches = run_bop_ycbv(dev, card, work)
        tless_launches, tless_err = run_bop_tless(dev, card, work)
        mini_launches = run_mini_vsd(dev, card, work)
        print(f"phase 14: {time.perf_counter() - t14:.1f} s [{card}]")

        # 15. MP6D, ITODD and the flat path -------------------------------
        os.environ["RDPN6D_DATA_ROOT"] = os.path.join(work, "data15")
        t15 = time.perf_counter()
        mp6d_launches = run_mp6d(dev, card, work)
        itodd_launches, itodd_err = run_itodd(dev, card, work)
        flat_launches, flat_err = run_flat(dev, card, work, frames)
        print(f"phase 15: {time.perf_counter() - t15:.1f} s [{card}]")

        # 16. test.use_pnp's refinement and the model variants ------------
        t16 = time.perf_counter()
        ransac_err, ransac_times = check_ransac_kabsch(dev, card)
        pnp_serve_launches = run_ransac_serving(dev, card, cfg, assets,
                                                frames)
        pnp_eval_launches = run_ransac_eval(dev, card, work, bf16_mean)
        for name, opts in VARIANTS.items():
            variant_forward(dev, card, work, name, opts)
        print(f"phase 16: {time.perf_counter() - t16:.1f} s [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # each phase's launches on its main path, summed by kernel (the served
    # pass's roi_crop as counted before the profiled passes)
    total: dict = {}
    for got in (dict(launches, roi_crop=crop_launches), train_launches,
                label_launches, eval_launches, disk_launches, lmo_launches,
                serve8, eval8, dist_launches, mh_launches, ycbv_launches,
                tless_launches, mini_launches, mp6d_launches,
                itodd_launches, flat_launches, pnp_serve_launches,
                pnp_eval_launches):
        add_launches(total, got)
    result = {"kernels": [{
        "name": "min_dist2", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/min_dist2.cu",
        "replaces": "rdpn6d_tpu/ops/pallas_kernels.py:57",
        "launches": total.get("min_dist2", 0),
        "max_abs_err": max(errs.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms}, {
        "name": "region_label", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/region_label.cu",
        "replaces": "rdpn6d_tpu/ops/region.py:21",
        "launches": total.get("region_label", 0),
        "max_abs_err": label_err, **label_times}, {
        "name": "gt_labels", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/region_label.cu",
        "replaces": "rdpn6d_tpu/data/pipeline.py:197",
        "launches": total.get("gt_labels", 0),
        "max_abs_err": max(gt_err, tless_err["gt_labels"],
                           itodd_err["gt_labels"], flat_err),
        **gt_times}, {
        "name": "surface_labels", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/region_label.cu",
        "replaces": "rdpn6d_tpu/data/pipeline.py:222",
        "launches": total.get("surface_labels", 0),
        "max_abs_err": max(surface_err, tless_err["surface_labels"],
                           itodd_err["surface_labels"]),
        **surface_times}, {
        "name": "int8_conv", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/int8_conv.cu",
        "replaces": "rdpn6d_tpu/models/quant.py:42",
        "launches": total.get("int8_conv", 0),
        "max_abs_err": int8_err, **int8_times}, {
        "name": "quantize_act", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/int8_conv.cu",
        "replaces": "rdpn6d_tpu/models/quant.py:32",
        "launches": total.get("quantize_act", 0),
        "max_abs_err": quant_err, **quant_times}, {
        "name": "bn_relu_quantize", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/int8_conv.cu",
        "replaces": "rdpn6d_tpu/models/quant.py:140",
        "launches": total.get("bn_relu_quantize", 0),
        "max_abs_err": fused_err, **fused_times}, {
        "name": "roi_crop", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/roi_crop.cu",
        "replaces": "rdpn6d_tpu/ops/warp.py:130",
        "launches": total.get("roi_crop", 0),
        "max_abs_err": crop_err, **crop_times}, {
        "name": "ransac_kabsch", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/ransac_kabsch.cu",
        "replaces": "rdpn6d_tpu/ops/ransac_kabsch.py:125",
        "launches": total.get("ransac_kabsch", 0),
        "max_abs_err": ransac_err, **ransac_times}], "card": card}
    print(card)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
