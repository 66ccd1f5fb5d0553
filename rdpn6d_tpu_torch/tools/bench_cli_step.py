"""Attribute the training CLI's wall-clock an iteration to its stages.

Counterpart of ``tools/bench_cli_step.py``. Rebuilds ``main``'s grouped
train path from ``configs/mini.py`` on a dataset tree — records
(``load_train_records``), the grouped loader (``train_group_iterator``
with ``yield_keys``), the device frame cache (``DeviceFrameCache.stack``),
``preprocess_rois_grouped(train=True)``, the train step and the loss
readback — and times each stage to a synchronize of the card, then the
whole loop pipelined as ``Trainer`` runs it (no synchronize but the
loss readback), so that the gap between the step alone and the CLI's
iteration decomposes into host produce / cache stack and copy /
preprocess / train step / readback, and what pipelining recovers.

Usage (on a generated tree, e.g. ``tools.make_mini_bop``):
  RDPN6D_DATA_ROOT=ROOT python -m rdpn6d_tpu_torch.tools.bench_cli_step \\
      --split lm_mini_train --batch 24 --iters 30 [--opts ...] \\
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

import numpy as np
import torch


def run(args) -> dict:
    """Warm up (one synchronized iteration and an epoch of pipelined
    ones), time ``args.iters`` synchronized and ``args.iters`` pipelined
    iterations; print and return the JSON dict."""
    from ..configs import mini
    from ..data.device_cache import DeviceFrameCache, upload_frame, \
        widen_depth
    from ..data.loader import load_train_records, train_group_iterator
    from ..data.pipeline import preprocess_rois_grouped
    from ..models import RDPN, init_weights
    from ..parallel import create_train_state, make_train_step
    from ..solver import build_schedule
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    work = tempfile.mkdtemp(prefix="bench_cli_step_")
    cfg = mini.get_config().apply_opts(
        [f'data.train_datasets=["{args.split}"]',
         f"solver.ims_per_batch={args.batch}",
         f'train.output_dir="{work}"', *args.opts])
    cache_dir = f"{work}/cache"

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    it = None
    try:
        n_records = len(load_train_records(cfg, [args.split],
                                           cache_dir=cache_dir))
        iters_per_epoch = max(n_records // args.batch, 1)
        print(f"{n_records} records, {iters_per_epoch} iters/epoch",
              flush=True)

        model = init_weights(RDPN(cfg), torch.Generator().manual_seed(
            cfg.train.seed)).to(device)
        schedule = build_schedule(cfg, 1000)
        state = create_train_state(cfg, model, lr=schedule(0))
        step_fn = make_train_step(cfg, schedule)
        generator = torch.Generator(device=device).manual_seed(
            cfg.train.seed)

        dev_cache = DeviceFrameCache(cfg.data.device_frame_cache_mb << 20,
                                     device) \
            if cfg.data.device_frame_cache_mb > 0 else None
        it = train_group_iterator(cfg, [args.split], seed=0,
                                  batch_size=args.batch,
                                  cache_dir=cache_dir,
                                  frame_bucket=cfg.data.frame_bucket,
                                  yield_keys=dev_cache is not None)

        def one_iter(synced: bool) -> dict[str, float]:
            nonlocal state
            t = {}
            t0 = time.perf_counter()
            gb = next(it)
            t["host_produce"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            if dev_cache is not None:
                frames = dev_cache.stack(gb["frame_slots"])
            else:
                frames = widen_depth(upload_frame(gb["frames"], device))
            if synced:
                sync()
            t["cache_stack_h2d"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            rois = upload_frame(gb["rois"], device)
            batch = preprocess_rois_grouped(cfg, frames, rois, train=True,
                                            generator=generator)
            if synced:
                sync()
            t["preprocess"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            if synced:
                sync()
            t["train_step"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            total = float(metrics["total_loss"])
            t["loss_readback"] = time.perf_counter() - t0
            if not np.isfinite(total):
                raise FloatingPointError("non-finite loss in bench")
            return t

        # warm: the first iteration, then an epoch of host batches so the
        # host LRU and the device cache are hot (the steady state)
        one_iter(synced=True)
        if args.warm_epoch:
            t0 = time.perf_counter()
            for _ in range(iters_per_epoch):
                one_iter(synced=False)
            wall = time.perf_counter() - t0
            print(f"warm epoch: {wall:.1f}s "
                  f"({wall / iters_per_epoch * 1000:.0f} ms/it cold-ish, "
                  "pipelined)", flush=True)

        acc: dict[str, list[float]] = {}
        for _ in range(args.iters):
            for k, v in one_iter(synced=True).items():
                acc.setdefault(k, []).append(v)
        sync_ms = {k: float(np.median(v)) * 1000 for k, v in acc.items()}
        sync_total = sum(sync_ms.values())

        t0 = time.perf_counter()
        for _ in range(args.iters):
            one_iter(synced=False)
        pipe_ms = (time.perf_counter() - t0) / args.iters * 1000
    finally:
        if it is not None:
            it.close()
        shutil.rmtree(work, ignore_errors=True)

    result = {
        "batch": args.batch,
        "sync_ms": sync_ms,
        "sync_total_ms": sync_total,
        "pipelined_ms_per_iter": pipe_ms,
        "pipelining_recovery_ms": sync_total - pipe_ms,
    }
    print(json.dumps(result, indent=1), flush=True)
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--split", default="lm_mini_train")
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--warm-epoch", action="store_true", default=True,
                   help="run one full epoch of host batches first so the "
                        "host LRU + device cache measure warm (the "
                        "steady-state regime)")
    p.add_argument("--opts", nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
