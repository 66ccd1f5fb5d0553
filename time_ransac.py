#!/usr/bin/env python3
"""Device time of the port's RANSAC-Kabsch kernel (``rdpn6d_tpu_torch``,
``ops/ransac_kabsch.ransac_kabsch``, the device half of ``test.use_pnp``'s
refinement) on one NVIDIA GPU, at N = 4096 points (lm13's 64x64 head), H =
128 hypotheses of S = 4 correspondences, and three batches:

     6 ROIs   a served frame's detections (``chip_smoke.py`` phase 16(b))
    16 ROIs   the served batch (phase 16(a)'s timed shape)
    32 ROIs   an eval batch (phase 16(c))

    python3 time_ransac.py [--root DIR] [--out DIR]
    python3 time_ransac.py --root PARENT --root CHANGE [--out DIR]

``--root`` names the directory whose ``rdpn6d_tpu_torch`` is timed
(default: the one beside this script). The inputs are
``chip_smoke.ransac_inputs`` (seeded, outliers at 0/30/60%, 85% of the
mask set), the same whatever the tree. For each batch it prints the
device time a call (queued behind filler work so that the host's cost is
hidden, ``chip_smoke.queued_ms``), CUDA events over a burst of calls, the
share of ``chip_smoke.ransac_bound``, the blocks of a ROI's cluster (1
for a tree without clusters) and the SMs they cover, then the kernel's
registers and spills from its build log, beside the card's name and power
limit, and one JSON line.

Given two trees, such as a change and its parent unpacked with ``git
archive``, it times them in turns on one card, each in a process of its
own: the first, the second, the second, the first. Each run saves its
outputs (R, t, ratio, best hypothesis, score at each batch) to ``--out``
(default ``chiprun_out/time_ransac``) as ``run<i>.npz``, cleared first;
every run is then held against the first: score, best hypothesis and
ratio bit-equal, R and t within 1e-5. Exits non-zero where one is not,
where a run fails, or without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BATCHES = (6, 16, 32)
N_POINTS = 4096
CALLS = 200          # queued calls a timing (their median)
BURST = 50           # calls a CUDA-event burst
POSE_TOL = 1e-5      # R and t of two trees' fits with the same best


def time_tree(root: str, save: str) -> int:
    """Times the kernel of the tree under ``root`` and saves its outputs
    to ``save``."""
    import numpy as np
    import torch

    import chip_smoke as cs    # this script's own: timers, inputs, bound

    sys.path.insert(0, root)
    import rdpn6d_tpu_torch
    from rdpn6d_tpu_torch.ops import cuda_build
    from rdpn6d_tpu_torch.ops import ransac_kabsch as rk

    pkg = os.path.dirname(os.path.abspath(rdpn6d_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        print(f"time_ransac: imported {pkg}, not the one under {root}",
              file=sys.stderr)
        return 2
    card = cs.nvidia_smi("name,power.limit")
    dev = torch.device("cuda")
    index = torch.cuda.current_device()
    tree = os.path.relpath(root, HERE)
    sms = cuda_build.sm_count(index)
    result = {"root": tree, "card": card, "batches": {}}
    saved = {}
    for B in BATCHES:
        args_b, _, _ = cs.ransac_inputs(B, N_POINTS, 50, dev, special=False)

        def run():
            return rk.ransac_kabsch(*args_b, cs.RANSAC_THR)

        out = run()
        torch.cuda.synchronize()
        for k, v in zip(("R", "t", "ratio", "best", "score"), out):
            saved[f"{k}_{B}"] = v.cpu().numpy()
        ms = cs.queued_ms(run, iters=CALLS)
        events_ms = cs.cuda_ms(run, iters=BURST)
        bound_ms, bound_by = cs.ransac_bound(B, N_POINTS, rk.NUM_HYPS)
        C = rk.cluster_blocks(
            B, rk.cluster_slots(index),
            rk.cluster_sizes(N_POINTS, rk.NUM_HYPS, rk.SAMPLE_SIZE)) \
            if hasattr(rk, "cluster_blocks") else 1
        print(f"time_ransac: {tree} ransac_kabsch {B} ROIs x {N_POINTS} "
              f"points x {rk.NUM_HYPS} hypotheses: device time (queued) "
              f"{ms:.5f} ms, {100 * bound_ms / ms:.1f}% of its bound "
              f"{bound_ms:.5f} ms ({bound_by}); CUDA events over a burst "
              f"{events_ms:.5f} ms; a cluster of {C} blocks a ROI, {B * C} "
              f"blocks for the card's {sms} SMs [{card}]")
        result["batches"][B] = {"queued_ms": ms, "events_ms": events_ms,
                                "bound_ms": bound_ms, "cluster": C}
    _, built = cuda_build.load(rk.KERNEL)
    usage = {n: u for n, u in cuda_build.ptxas_usage(built.log).items()
             if "ransac_kabsch_kernel" in n}
    print(f"time_ransac: {tree} ransac_kabsch build: " + "; ".join(
        f"{u['registers']} registers, {u['spill_stores']}/"
        f"{u['spill_loads']} bytes spilled, {u['smem']} bytes static smem"
        for u in usage.values()))
    result["ptxas"] = usage
    os.makedirs(os.path.dirname(save), exist_ok=True)
    np.savez(save, **saved)
    print(json.dumps(result))
    return 0


def compare(runs: list[tuple[str, str]]) -> bool:
    """Holds every run's saved outputs against the first run's; prints a
    line a run and batch and returns whether all agree."""
    import numpy as np

    first_tree, first = runs[0]
    ref = np.load(first)
    ok = True
    for i, (tree, path) in enumerate(runs[1:], 1):
        got = np.load(path)
        for B in BATCHES:
            same = {k: bool(np.array_equal(got[f"{k}_{B}"], ref[f"{k}_{B}"]))
                    for k in ("score", "best", "ratio")}
            dR, dt = (float(np.abs(got[f"{k}_{B}"] - ref[f"{k}_{B}"]).max())
                      for k in ("R", "t"))
            good = all(same.values()) and dR <= POSE_TOL and dt <= POSE_TOL
            ok &= good
            print(f"time_ransac: run {i} ({tree}) against run 0 "
                  f"({first_tree}), {B} ROIs: " + ", ".join(
                      f"{k} {'bit-equal' if v else 'DIFFERS'}"
                      for k, v in same.items())
                  + f"; max |dR| {dR:.3e}, max |dt| {dt:.3e} (tol "
                  f"{POSE_TOL}){'' if good else ': FAILED'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append",
                    help="directory holding the rdpn6d_tpu_torch to time; "
                    "twice to time two trees in turns and compare them")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "time_ransac"),
                    help="directory for each run's outputs")
    ap.add_argument("--save", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_ransac: no CUDA device", file=sys.stderr)
        return 2
    roots = [os.path.abspath(r) for r in args.root or [HERE]]
    if len(roots) > 2:
        ap.error("at most two --root")
    for root in roots:
        if not os.path.isdir(os.path.join(root, "rdpn6d_tpu_torch")):
            print(f"time_ransac: no rdpn6d_tpu_torch/ under {root}",
                  file=sys.stderr)
            return 2
    if len(roots) == 1:
        return time_tree(roots[0], args.save or os.path.join(
            args.out, "run0.npz"))
    os.makedirs(args.out, exist_ok=True)
    order = [roots[0], roots[1], roots[1], roots[0]]
    runs = [(os.path.relpath(r, HERE), os.path.join(args.out, f"run{i}.npz"))
            for i, r in enumerate(order)]
    for _, path in runs:
        if os.path.exists(path):
            os.remove(path)
    for root, (tree, path) in zip(order, runs):
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              "--root", root, "--save", path])
        if rc != 0:
            print(f"time_ransac: the run of {tree} failed ({rc})",
                  file=sys.stderr)
            return rc
    return 0 if compare(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
