"""Training input-path benchmark: the flat per-ROI path against the
frame-deduplicated grouped one.

Counterpart of ``tools/bench_input.py``. Times the host decode -> copy to
the device -> preprocessing pipeline alone, over the same on-disk
multi-instance split for both loaders: ``flat`` is
``train_frame_iterator`` with ``preprocess_batch`` (full float32 frames a
ROI), ``grouped`` is ``train_group_iterator`` with
``preprocess_rois_grouped`` (uint8 / uint16 frames once a frame, compact
per-ROI GT). Each preprocessed batch launches ``roi_crop`` and
``gt_labels`` (or ``surface_labels`` on a split without xyz crops) on a
card. Distinct batches every iteration, a value read back every
iteration, warm-up batches excluded. Prints a JSON line a mode with
poses/s and the host bytes a pose that cross to the device.

Usage (after ``python -m rdpn6d_tpu_torch.tools.make_mini_bop --out ROOT``):
  RDPN6D_DATA_ROOT=ROOT python -m rdpn6d_tpu_torch.tools.bench_input \\
      [--batch 192] [--iters 8] [--split lm_mini_train] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _nbytes(tree: dict) -> int:
    return sum(np.asarray(v).nbytes for v in tree.values())


def run(args, cfg=None) -> list[dict]:
    """Each mode of ``args.modes``: print and return its JSON line's
    dict. ``cfg`` defaults to the flagship ``Config()``, as the JAX
    tool's."""
    from ..config import Config
    from ..data.device_cache import upload_frame, widen_depth
    from ..data.loader import train_frame_iterator, train_group_iterator
    from ..data.pipeline import preprocess_batch, preprocess_rois_grouped
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = Config() if cfg is None else cfg
    generator = torch.Generator(device=device).manual_seed(0)

    def to_device(tree: dict) -> dict:
        return {k: torch.from_numpy(np.asarray(v)).to(device)
                for k, v in tree.items()}

    lines = []
    for mode in args.modes:
        if mode == "flat":
            it = train_frame_iterator(cfg, args.split, batch_size=args.batch)

            def step(host):
                out = preprocess_batch(cfg, to_device(host), train=True,
                                       generator=generator)
                return out["roi_img"], _nbytes(host)
        elif mode == "grouped":
            it = train_group_iterator(cfg, args.split, batch_size=args.batch)

            def step(host):
                frames = widen_depth(upload_frame(host["frames"], device))
                out = preprocess_rois_grouped(
                    cfg, frames, to_device(host["rois"]), train=True,
                    generator=generator)
                return out["roi_img"], (_nbytes(host["frames"])
                                        + _nbytes(host["rois"]))
        else:
            raise ValueError(f"unknown mode {mode!r}: flat or grouped")
        try:
            total_bytes = 0
            for _ in range(args.warmup):
                img, _ = step(next(it))
                float(img.sum())
            t0 = time.perf_counter()
            for _ in range(args.iters):
                img, nb = step(next(it))
                float(img.sum())         # value readback
                total_bytes += nb
            dt = (time.perf_counter() - t0) / args.iters
        finally:
            it.close()
        line = {
            "metric": f"input-path poses/sec ({mode})",
            "batch": args.batch,
            "ms_per_batch": dt * 1000,
            "value": args.batch / dt,
            "unit": "poses/sec",
            "mb_per_pose": total_bytes / args.iters / args.batch / 1e6,
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=192)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--split", default="lm_mini_train")
    p.add_argument("--modes", nargs="*", default=["flat", "grouped"])
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
