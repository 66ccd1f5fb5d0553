#!/usr/bin/env python3
"""Device time, by kernel, of the lm13 train step of the PyTorch/CUDA port
(``rdpn6d_tpu_torch``) on one NVIDIA GPU, under torch.profiler: the
train-mode preprocessing of 24 ROIs alone, then a whole step
(preprocessing, forward, losses, backward, Ranger); before them, the
wall time of untraced steps.

    python3 profile_step.py [--root DIR]

``--root`` names the directory whose ``rdpn6d_tpu_torch`` is profiled
(default: the one beside this script), so that two trees, such as a
change and its parent unpacked with ``git archive``, are compared in one
run on one card. Weights and inputs are ``chip_smoke.py``'s (lm13 at full
width with bf16 autocast, seeded init; 8 rendered 480x640 frames of 3
cubes with per-ROI float16 xyz maps and packed masks), the same whatever
the tree. After 3 warm-up steps, prints the median, lowest and highest ms
of 10 untraced steps (each synchronized), then for each traced pass its wall
ms, device busy ms, kernel launches and the largest kernels, beside the
card's name and power limit. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WARMUP_STEPS = 3
TIMED_STEPS = 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="directory holding the rdpn6d_tpu_torch to profile")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "rdpn6d_tpu_torch")):
        print(f"profile_step: no rdpn6d_tpu_torch/ under {root}",
              file=sys.stderr)
        return 2
    import chip_smoke as cs    # this script's own: the helpers and inputs

    sys.path.insert(0, root)
    import rdpn6d_tpu_torch

    pkg = os.path.dirname(os.path.abspath(rdpn6d_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        print(f"profile_step: imported {pkg}, not the one under {root}",
              file=sys.stderr)
        return 2
    card = cs.nvidia_smi("name,power.limit")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="profile_step_") as out:
        return profile(cs, root, card, dev, out)


def profile(cs, root, card, dev, out) -> int:
    """The untimed warm-up, the timed steps and the traced passes; the
    trainer writes under ``out``."""
    import torch

    from rdpn6d_tpu_torch.data.pipeline import preprocess_rois_grouped
    from rdpn6d_tpu_torch.engine.trainer import Trainer
    from rdpn6d_tpu_torch.models import RDPN, init_weights

    cfg = cs.train_config(amp=True, out_dir=out)
    frames, rois = cs.train_inputs(cfg, 10, 8, cs.TRAIN_ROIS // 8)
    frames = {k: torch.from_numpy(v).to(dev) for k, v in frames.items()}
    rois = {k: torch.from_numpy(v).to(dev) for k, v in rois.items()}
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(0))
    trainer = Trainer(cfg, model, total_iters=1000, device=dev)

    def labels():
        return preprocess_rois_grouped(cfg, frames, rois, train=True,
                                       generator=trainer.generator)

    def step():
        trainer.state, m = trainer.step_fn(trainer.state, labels())
        float(m["total_loss"])

    for _ in range(WARMUP_STEPS):
        step()
    ms = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    ms.sort()
    print(f"profile_step: rdpn6d_tpu_torch from "
          f"{os.path.relpath(root, HERE)} [{card}]")
    print(f"steps: {TIMED_STEPS} untraced train steps, ms/step median "
          f"{ms[len(ms) // 2]:.2f}, lowest {ms[0]:.2f}, highest "
          f"{ms[-1]:.2f}")
    cs.profile_pass(f"train preprocessing, {cs.TRAIN_ROIS} ROIs", labels,
                    rows=100)
    cs.profile_pass("train step, bf16 autocast", step, rows=25)
    return 0


if __name__ == "__main__":
    sys.exit(main())
