#!/usr/bin/env python3
"""Device time of the port's ROI crop kernel, and device time, device
operations and host time of its ROI preprocessing (``rdpn6d_tpu_torch``,
``data/pipeline.preprocess_rois_grouped``) on one NVIDIA GPU, at lm13's
full width. First ``roi_crop`` alone (``ops/roi_crop.roi_crop``: device
time queued, ``chip_smoke.queued_ms``, over 200 calls) at the three shapes
of ``chip_smoke.ROI_CROP_SHAPES``: the served batch (16 ROIs of one
480x640 frame, depth in metres), an eval batch (32 ROIs of 8 frames, raw
int32 depth with a factor) and the train shape (24 ROIs of 8 frames, raw
depth, ``normalize=False``), each beside its bound
(``chip_smoke.roi_crop_bound``), with the kernel's registers and spills
from its build log; then the preprocessing:

    serve  the eval half of a served batch: 16 detections of one 480x640
           frame (uint8 RGB, depth in metres), as ``Predictor`` hands them
           over (chip_smoke's phase-2 frame and boxes);
    train  lm13's train-mode preprocessing of 24 ROIs of 8 480x640 frames
           (chip_smoke's phase-6 scenes: float16 xyz maps, packed masks;
           boxes fixed, no DZI draw), the crop and the labels;

and then served poses/s end to end: ``Predictor.predict`` of lm13 at full
width in bf16 (seeded weights) on 16 frames of 16 detections (256 poses,
one batch of 16 a frame; chip_smoke's phase-12 traffic), a warm-up pass
and 4 timed passes (host clock, synchronized).

    python3 time_crop.py [--root DIR] [--crop-only]

``--root`` names the directory whose ``rdpn6d_tpu_torch`` is timed
(default: the one beside this script), so that two trees, such as a change
and its parent unpacked with ``git archive``, are compared in one run on
one card: parent, change, change, parent. Both call the same entry point
on the same seeded inputs, whatever the tree. For each: the profiler's
device time a call (``chip_smoke.device_ms``), the device time of a call
queued behind filler work (``chip_smoke.queued_ms``, launch latency
included), the device operations the profiler sees in one call (kernels,
copies, fills) and the host ms to enqueue one call (wall time around the
call, no synchronize; median). Prints them beside the card's name and
power limit, then one JSON line. ``--crop-only`` stops after the kernel
alone. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CALLS = 20
TRAIN_FRAMES = 8
SERVE_FRAMES = 16
SERVE_PASSES = 4


def host_ms(fn, iters: int = CALLS) -> float:
    """Median host ms to enqueue one call of ``fn``: the wall time around
    the call alone, the card drained before each."""
    import numpy as np
    import torch

    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="directory holding the rdpn6d_tpu_torch to time")
    ap.add_argument("--crop-only", action="store_true",
                    help="time roi_crop alone, not the preprocessing and "
                         "served poses/s")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_crop: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "rdpn6d_tpu_torch")):
        print(f"time_crop: no rdpn6d_tpu_torch/ under {root}",
              file=sys.stderr)
        return 2
    import chip_smoke as cs    # this script's own: the timers and inputs
    from time_labels import device_ops

    sys.path.insert(0, root)
    import rdpn6d_tpu_torch
    from rdpn6d_tpu_torch.configs import lm13
    from rdpn6d_tpu_torch.data.pipeline import (
        dzi_jitter,
        preprocess_rois_grouped,
    )

    pkg = os.path.dirname(os.path.abspath(rdpn6d_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        print(f"time_crop: imported {pkg}, not the one under {root}",
              file=sys.stderr)
        return 2
    card = cs.nvidia_smi("name,power.limit")
    dev = torch.device("cuda")
    tree = os.path.relpath(root, HERE)
    result = {"root": tree, "card": card, "roi_crop": crop_alone(cs, tree,
                                                                 card, dev)}
    if args.crop_only:
        print(json.dumps(result))
        return 0

    # the served batch, as Predictor.predict builds it
    cfg = lm13.get_config()
    rgb, depth, dets = cs.make_frames(seed=21, counts=(cs.SERVE_BATCH,))[0]
    B = len(dets)
    serve_frames = {"rgb": torch.from_numpy(rgb)[None].to(dev),
                    "depth": torch.from_numpy(depth)[None].to(dev),
                    "K": torch.from_numpy(cs.K_LM)[None].to(dev)}
    serve_rois = {
        "frame_idx": torch.zeros(B, dtype=torch.long, device=dev),
        "bbox": torch.from_numpy(np.stack([d.bbox_xyxy for d in dets]))
        .to(dev),
        "fps": torch.zeros(B, cfg.head.num_regions, 3, device=dev),
        "extent": torch.full((B, 3), 0.1, device=dev),
        "roi_cls": torch.arange(B, device=dev) % cfg.head.num_classes}

    # the train batch: phase 6's scenes, boxes fixed
    tcfg = cs.train_config(amp=True, out_dir="")      # nothing is written
    frames, rois = cs.train_inputs(tcfg, 10, TRAIN_FRAMES,
                                   cs.TRAIN_ROIS // TRAIN_FRAMES)
    train_frames = {k: torch.from_numpy(v).to(dev) for k, v in frames.items()}
    train_rois = {k: torch.from_numpy(v).to(dev) for k, v in rois.items()}
    box = dzi_jitter(train_rois["bbox"], (480, 640),
                     pad_scale=tcfg.data.dzi_pad_scale)

    cases = {
        "serve": (f"eval half, {B} ROIs of one 480x640 frame",
                  lambda: preprocess_rois_grouped(cfg, serve_frames,
                                                  serve_rois)),
        "train": (f"train mode, {cs.TRAIN_ROIS} ROIs of {TRAIN_FRAMES} "
                  "480x640 frames with xyz maps",
                  lambda: preprocess_rois_grouped(tcfg, train_frames,
                                                  train_rois, train=True,
                                                  center_scale=box)),
    }
    for name, (what, fn) in cases.items():
        dev_ms = cs.device_ms(fn, iters=CALLS)
        # ~1.1 TFLOP of filler: longer than the host takes to launch the
        # call's operations, so they run back to back
        q_ms = cs.queued_ms(fn, iters=CALLS, filler=8192)
        ops = device_ops(fn)
        h_ms = host_ms(fn)
        print(f"time_crop: {tree} {name}: preprocess_rois_grouped, lm13, "
              f"{what}: device time {dev_ms:.4f} ms, queued {q_ms:.4f} ms, "
              f"{ops} device operations a call, host {h_ms:.3f} ms to "
              f"enqueue a call [{card}]")
        result[name] = {"device_ms": dev_ms, "queued_ms": q_ms,
                        "device_ops": ops, "host_ms": h_ms}
    result["poses_per_s"] = served_rates(cs, tree, card)
    print(json.dumps(result))
    return 0


def crop_alone(cs, tree, card, dev) -> dict:
    """``roi_crop``'s device time (queued) at each of
    ``cs.ROI_CROP_SHAPES``, beside its bound, and the registers and spills
    of each of its instantiations."""
    from rdpn6d_tpu_torch.configs import lm13
    from rdpn6d_tpu_torch.ops import cuda_build
    from rdpn6d_tpu_torch.ops.roi_crop import roi_crop

    d = lm13.get_config().data
    S, O = d.input_res, d.out_res
    out = {}
    for name in cs.ROI_CROP_SHAPES:
        what, args, normalize = cs.roi_crop_shape(name, dev)

        def run():
            return roi_crop(*args, S, O, d.pixel_mean, d.pixel_std,
                            normalize=normalize)

        ms = cs.queued_ms(run, iters=200)
        bound_ms, bound_by = cs.roi_crop_bound(args[0], args[1], args[4],
                                               args[5], args[6], S, O)
        print(f"time_crop: {tree} roi_crop alone, {what} -> {S}/{O}: device "
              f"time (queued) {ms:.5f} ms, {100 * bound_ms / ms:.1f}% of its "
              f"bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
        out[name] = {"queued_ms": ms, "bound_ms": bound_ms}
    _, built = cuda_build.load("roi_crop")
    usage = cuda_build.ptxas_usage(built.log)
    print(f"time_crop: {tree} roi_crop build: " + "; ".join(
        f"{n}: {u['registers']} registers, {u['spill_stores']}/"
        f"{u['spill_loads']} bytes spilled, {u['smem']} bytes smem"
        for n, u in usage.items()))
    out["ptxas"] = usage
    return out


def served_rates(cs, tree, card) -> list[float]:
    """Served poses/s of lm13 bf16 through ``Predictor.predict``, one
    figure a timed pass."""
    import numpy as np
    import torch

    from rdpn6d_tpu_torch.configs import lm13
    from rdpn6d_tpu_torch.engine.predictor import Predictor

    cfg = lm13.get_config().apply_opts(['head.init="fan_in"'])
    assets = cs.lm_assets(cfg.head.num_regions, 4096, seed=1)
    frames = cs.make_frames(seed=5, counts=(cs.SERVE_BATCH,) * SERVE_FRAMES)
    pred = cs.physical_z(Predictor(
        cfg, assets, batch_size=cs.SERVE_BATCH, dtype=torch.bfloat16,
        device="cuda", allow_random_init=True))
    cs.serve(pred, frames)                               # warm-up
    n = cs.SERVE_BATCH * SERVE_FRAMES
    rates = [n / cs.serve(pred, frames)[1] for _ in range(SERVE_PASSES)]
    print(f"time_crop: {tree} served poses/s, lm13 bf16, {SERVE_FRAMES} "
          f"frames of {cs.SERVE_BATCH} detections a pass: median "
          f"{np.median(rates):.1f}, passes "
          f"{', '.join(f'{r:.1f}' for r in rates)} [{card}]")
    return rates


if __name__ == "__main__":
    sys.exit(main())
