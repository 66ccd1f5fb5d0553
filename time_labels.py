#!/usr/bin/env python3
"""Device time of the port's train-label kernels (``rdpn6d_tpu_torch``,
``csrc/region_label.cu``) at lm13's and lmo's train shapes, K = 32
keypoints, on one NVIDIA GPU:

    gt_labels       24 ROIs of 480x640 packed masks + float16 xyz -> 64x64
    region_label    24 ROIs of 64x64 xyz maps
    surface_labels  24 ROIs of 8 480x640 depth frames + packed masks
                    -> 64x64

and, past one 64-keypoint tile, at K = 96 and 200 where the tree takes
them (a tree whose kernels refuse K > 64 prints "refused", one without
``surface_labels`` "absent"). Then the whole depth-surface branch of the
train labels as a user calls it: ``preprocess_rois_grouped(train=True)``
of lm13 at full width on 24 ROIs of 8 480x640 frames without GT xyz maps
(chip_smoke's phase-6 scenes, boxes fixed, no colour aug), with its
device time, its queued time and the number of device operations
(kernels, copies, fills) the profiler sees in one call.

    python3 time_labels.py [--root DIR]

``--root`` names the directory whose ``rdpn6d_tpu_torch`` is timed
(default: the one beside this script), so that two trees, such as a change
and its parent unpacked with ``git archive``, are compared in one run on
one card: parent, change, change, parent. Inputs are ``chip_smoke.py``'s
seeded label inputs, the same whatever the tree. Each shape is timed two
ways, as a median over calls: the profiler's device time
(``chip_smoke.device_ms``, as phase 2 reports it) and CUDA events around
each call queued behind filler work (``chip_smoke.queued_ms``, launch
latency included). Prints them beside the card's name and power limit,
then one JSON line; first, the registers ptxas gave each kernel of the
tree's build. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROIS = 24
FRAMES = 8
CALLS = 200


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="directory holding the rdpn6d_tpu_torch to time")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_labels: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "rdpn6d_tpu_torch")):
        print(f"time_labels: no rdpn6d_tpu_torch/ under {root}",
              file=sys.stderr)
        return 2
    import chip_smoke as cs    # this script's own: the timers and inputs

    sys.path.insert(0, root)
    import rdpn6d_tpu_torch
    from rdpn6d_tpu_torch.ops.gt_labels import gt_labels
    from rdpn6d_tpu_torch.ops.region import region_label
    try:
        from rdpn6d_tpu_torch.ops.surface_labels import surface_labels
    except ImportError:
        surface_labels = None

    pkg = os.path.dirname(os.path.abspath(rdpn6d_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        print(f"time_labels: imported {pkg}, not the one under {root}",
              file=sys.stderr)
        return 2
    card = cs.nvidia_smi("name,power.limit")
    dev = torch.device("cuda")
    tree = os.path.relpath(root, HERE)
    from rdpn6d_tpu_torch.ops import cuda_build

    _, built = cuda_build.load("region_label")
    print(f"time_labels: {tree} built {os.path.relpath(built.path, HERE)}: "
          + " | ".join(ln.strip() for ln in built.log.splitlines()
                       if "registers" in ln))
    out = cs.GT_LABELS_OUT_RES
    result = {"root": tree, "card": card, "kernels": []}
    for K in (32, 96, 200):
        inp = cs.gt_label_inputs(ROIS, 480, 640, K, 0, dev, "packed", True)
        lab = cs.label_inputs(ROIS, out, out, K, 1, dev)
        surf = cs.surface_label_inputs(ROIS, FRAMES, 480, 640, K, 0, dev,
                                       "packed")
        for name, fn in (("gt_labels", lambda: gt_labels(*inp, out)),
                         ("region_label", lambda: region_label(*lab)),
                         ("surface_labels",
                          lambda: surface_labels(*surf, out))):
            if name == "surface_labels" and surface_labels is None:
                print(f"time_labels: {tree} {name} K={K}: absent [{card}]")
                continue
            try:
                fn()
            except ValueError:
                print(f"time_labels: {tree} {name} K={K}: refused [{card}]")
                continue
            dev_ms = cs.device_ms(fn, iters=CALLS)
            q_ms = cs.queued_ms(fn, iters=CALLS)
            print(f"time_labels: {tree} {name} {ROIS} ROIs K={K}: device "
                  f"time {dev_ms:.5f} ms, queued {q_ms:.5f} ms [{card}]")
            result["kernels"].append({"name": name, "K": K,
                                      "device_ms": dev_ms,
                                      "queued_ms": q_ms})
    result["depth_branch"] = depth_branch(cs, tree, card, dev)
    print(json.dumps(result))
    return 0


def device_ops(fn) -> int:
    """The device operations (kernels, copies, fills) the profiler sees in
    one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False))


def depth_branch(cs, tree, card, dev) -> dict:
    """``preprocess_rois_grouped(train=True)`` of lm13 on 24 ROIs without
    GT xyz maps: device time, queued time and device operations a call."""
    import torch

    from rdpn6d_tpu_torch.data.pipeline import (
        dzi_jitter,
        preprocess_rois_grouped,
    )

    cfg = cs.train_config(amp=True, out_dir="")       # nothing is written
    frames, rois = cs.train_inputs(cfg, 10, FRAMES, ROIS // FRAMES,
                                   ship_xyz=False)
    frames = {k: torch.from_numpy(v).to(dev) for k, v in frames.items()}
    rois = {k: torch.from_numpy(v).to(dev) for k, v in rois.items()}
    box = dzi_jitter(rois["bbox"], (480, 640),
                     pad_scale=cfg.data.dzi_pad_scale)

    def fn():
        return preprocess_rois_grouped(cfg, frames, rois, train=True,
                                       center_scale=box)

    dev_ms = cs.device_ms(fn, iters=20)
    # ~1.1 TFLOP of filler: longer than the host takes to launch the
    # branch's operations, so they run back to back
    q_ms = cs.queued_ms(fn, iters=20, filler=8192)
    ops = device_ops(fn)
    print(f"time_labels: {tree} preprocess_rois_grouped(train=True) without "
          f"xyz, lm13, {ROIS} ROIs of {FRAMES} 480x640 frames: device time "
          f"{dev_ms:.4f} ms, queued {q_ms:.4f} ms, {ops} device operations "
          f"a call [{card}]")
    return {"device_ms": dev_ms, "queued_ms": q_ms, "device_ops": ops}


if __name__ == "__main__":
    sys.exit(main())
