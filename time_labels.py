#!/usr/bin/env python3
"""Device time of the port's train-label kernels (``rdpn6d_tpu_torch``,
``csrc/region_label.cu``) at lm13's train shapes, K = 32 keypoints, on one
NVIDIA GPU:

    gt_labels     24 ROIs of 480x640 packed masks + float16 xyz -> 64x64
    region_label  24 ROIs of 64x64 xyz maps

and, past one 64-keypoint tile, at K = 96 and 200 where the tree takes
them (a tree whose kernels refuse K > 64 prints "refused").

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
        for name, fn in (("gt_labels", lambda: gt_labels(*inp, out)),
                         ("region_label", lambda: region_label(*lab))):
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
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
