#!/usr/bin/env python3
"""Device time of the port's ``min_dist2`` kernel (``rdpn6d_tpu_torch``) at
the three shapes its paths give it, on one NVIDIA GPU, by CUDA events over
many launches:

    16 x 4096 x 4096   serve + score (``chip_smoke.py`` phases 2 and 4)
     8 x 3000 x 3000   the eval smoke's largest per-object launch (phase 9)
  1000 x 3000 x 3000   one object of LM-13's test split

    python3 time_min_dist2.py [--root DIR]

``--root`` names the directory whose ``rdpn6d_tpu_torch`` is timed
(default: the one beside this script), so that two trees, such as a change
and its parent unpacked with ``git archive``, are compared in one run on
one card: parent, change, change, parent. The inputs are seeded clouds
~0.9 m from the camera, the same whatever the tree. Prints, for each
shape, three times (each the mean over many launches), the bound
and the share of it, beside the card's name and power limit, then one JSON
line. Each shape is timed two ways: CUDA events around a burst of calls
(what a caller in a loop sees, the host's cost included where it is the
larger) and the device's time a call, each call queued behind filler work
so that the host's cost is hidden (``chip_smoke.queued_ms``); beside them
the host's time to enqueue a call. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((16, 4096, 4096, 200), (8, 3000, 3000, 500),
          (1000, 3000, 3000, 20))   # B, N, M, launches a timing
REPEATS = 3                         # timings of each shape
HOST_CALLS = 100


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="directory holding the rdpn6d_tpu_torch to time")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_min_dist2: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "rdpn6d_tpu_torch")):
        print(f"time_min_dist2: no rdpn6d_tpu_torch/ under {root}",
              file=sys.stderr)
        return 2
    import chip_smoke as cs    # this script's own: the timer and the bound

    sys.path.insert(0, root)
    import rdpn6d_tpu_torch
    from rdpn6d_tpu_torch.ops.min_dist import min_dist2

    pkg = os.path.dirname(os.path.abspath(rdpn6d_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        print(f"time_min_dist2: imported {pkg}, not the one under {root}",
              file=sys.stderr)
        return 2
    card = cs.nvidia_smi("name,power.limit")
    dev = torch.device("cuda")
    tree = os.path.relpath(root, HERE)
    result = {"root": tree, "card": card, "shapes": []}
    for B, N, M, iters in SHAPES:
        g = torch.Generator().manual_seed(B)
        shift = torch.tensor([0.0, 0.0, 0.9])
        a = (torch.randn(B, N, 3, generator=g) * 0.05 + shift).to(dev)
        b = (torch.randn(B, M, 3, generator=g) * 0.05 + shift).to(dev)
        ms = [cs.cuda_ms(lambda: min_dist2(a, b), iters=iters)
              for _ in range(REPEATS)]
        # the device's time a call, without the gaps a host-bound burst
        # leaves
        dev_ms = cs.queued_ms(lambda: min_dist2(a, b), iters=iters // 4)
        # the host's time to enqueue a call (few enough calls that the
        # launch queue never fills and blocks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            min_dist2(a, b)
        host_us = 1e6 * (time.perf_counter() - t0) / HOST_CALLS
        torch.cuda.synchronize()
        bound_ms, by = cs.min_dist2_bound(B, N, M)
        print(f"time_min_dist2: {tree} {B}x{N}x{M}: CUDA events "
              + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms, device time {dev_ms:.4f} ms, host {host_us:.1f} us "
              f"a call to enqueue; bound {bound_ms:.4f} ms ({by}): "
              f"{100 * bound_ms / min(ms):.1f}% (events, best) and "
              f"{100 * bound_ms / dev_ms:.1f}% (device) of bound [{card}]")
        result["shapes"].append({"B": B, "N": N, "M": M, "ms": ms,
                                 "device_ms": dev_ms, "host_us": host_us,
                                 "bound_ms": bound_ms, "bound_by": by})
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
