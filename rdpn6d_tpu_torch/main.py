"""CLI entry: train a config, or evaluate its checkpoint.

    python -m rdpn6d_tpu_torch.main --config-file CFG [--eval-only]
        [--resume] [--profile] [--device cuda|cpu] [--opts k=v ...]

Counterpart of ``rdpn6d_tpu/main.py`` on one device. Both branches dump the
config to ``<output_dir>/config.json`` and log to ``<output_dir>/log.txt``.

Training (no ``--eval-only``): the records of ``data.train_datasets`` give
the iterations (``solver.total_epochs`` x records // ``ims_per_batch``);
the trunk loads ``backbone.pretrained`` (skipped when ``--resume`` finds a
checkpoint); batches come from the frame-grouped decode pool through one
shared ``DeviceFrameCache`` (``data.device_frame_cache_mb``), with TRAIN2
mixing (``data.train2_datasets``, ``train2_ratio``); the trainer writes
``metrics.json`` and checkpoints under ``<output_dir>/ckpt``, resumes from
the latest with ``--resume``, and evaluates the live model on
``data.test_datasets`` every ``train.eval_period`` iterations. As in the
JAX package, ``--resume`` restores the model, the optimizer and the step,
and restarts the samplers and the DZI draws from their seeds.
``--profile`` traces the run with ``torch.profiler`` into
``<output_dir>/profile``.

``--eval-only`` runs ``run_eval`` on each of ``data.test_datasets`` with the
latest checkpoint in ``<output_dir>/ckpt`` (the port's format,
``engine/checkpoint.py``), writing the per-object table to the log,
``<split>_bop19.csv``, the recall curves under ``plots_<split>/`` and, with
a targets file and mssd/mspd asked for, the BOP19 AR.

Everything runs on ``cuda`` unless ``--device`` names another device.
``--debug``, ``--multihost`` and ``data.grouped_train=false`` are not
ported and raise.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="rdpn6d_tpu_torch")
    p.add_argument("--config-file", required=True)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="with --eval-only: coordinate-regression debug eval "
                        "(not ported)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--num-devices", type=int, default=0,
                   help="0 = all visible devices")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process run (not ported)")
    p.add_argument("--dist-coordinator", default="")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=-1)
    p.add_argument("--profile", action="store_true",
                   help="trace the training loop with torch.profiler into "
                        "<output_dir>/profile")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--opts", nargs="*", default=[])
    return p.parse_args(argv)


def setup_logging(output_dir: str) -> None:
    os.makedirs(output_dir, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        handlers=[logging.StreamHandler(),
                  logging.FileHandler(os.path.join(output_dir, "log.txt"))],
        force=True,
    )


def auto_output_dir(config_file: str) -> str:
    """``train.output_dir="auto"`` derives the run directory from the
    config path, with any ``:variant`` suffix:
    ``configs/so.py:tudl/can`` -> ``output/so/tudl/can``."""
    path, _, variant = config_file.partition(":")
    rel = os.path.splitext(path)[0]
    # only the part after the last "configs/", forced relative
    _, sep, tail = rel.rpartition("configs" + os.sep)
    rel = tail if sep else os.path.basename(rel)
    rel = rel.lstrip(os.sep)
    return os.path.join("output", rel, variant) if variant \
        else os.path.join("output", rel)


@contextlib.contextmanager
def _profiled(enabled: bool, trace_dir: str):
    """A torch.profiler trace of the block into ``trace_dir`` (a Chrome
    trace, ``trace.json``), or nothing."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def main(argv=None):
    """Training returns the final ``TrainState``; ``--eval-only`` returns
    {split: run_eval's result} for each test split."""
    args = parse_args(argv)
    if args.multihost:
        raise NotImplementedError("--multihost: multi-process runs are not "
                                  "ported (ROADMAP queue 1 item 16)")
    if args.debug:
        raise NotImplementedError("--debug: the coordinate-regression eval "
                                  "is not ported (ROADMAP queue 1 item 11)")
    from .config import load_config
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.config_file, args.opts)
    if cfg.train.output_dir == "auto":
        cfg = cfg.apply_opts(
            [f'train.output_dir="{auto_output_dir(args.config_file)}"'])
    if not args.eval_only and not cfg.data.grouped_train:
        raise NotImplementedError(
            "data.grouped_train=false: the flat train path is not ported "
            "(ROADMAP queue 1 item 10)")
    setup_logging(cfg.train.output_dir)
    logger = logging.getLogger("rdpn6d")
    cfg.dump(os.path.join(cfg.train.output_dir, "config.json"))
    logger.info(f"device: {device}")
    if args.eval_only:
        from .engine.eval_runner import run_eval

        return {split: run_eval(cfg, ckpt_dir=f"{cfg.train.output_dir}/ckpt",
                                split_name=split, device=device)
                for split in cfg.data.test_datasets}
    return train(cfg, args, device, logger)


def train(cfg, args, device, logger):
    """The train branch of ``main``."""
    import torch

    from .data.device_cache import DeviceFrameCache, upload_frame, \
        widen_depth
    from .data.loader import load_train_records, train_group_iterator
    from .engine.checkpoint import CheckpointManager
    from .engine.trainer import Trainer
    from .models import RDPN, init_weights

    out_dir = cfg.train.output_dir
    model = init_weights(RDPN(cfg),
                         torch.Generator().manual_seed(cfg.train.seed))
    if cfg.backbone.pretrained:
        # a resumed run's checkpoint replaces the trunk anyway
        has_ckpt = args.resume and CheckpointManager(
            f"{out_dir}/ckpt").latest_step() is not None
        if not has_ckpt:
            from .utils.pretrained import load_pretrained_backbone

            load_pretrained_backbone(model, cfg.backbone.pretrained,
                                     depth=cfg.backbone.depth)
            logger.info(f"trunk from {cfg.backbone.pretrained}")

    split = list(cfg.data.train_datasets)
    cache_dir = f"{out_dir}/cache"
    n_records = len(load_train_records(cfg, split, cache_dir=cache_dir))
    iters_per_epoch = max(n_records // cfg.solver.ims_per_batch, 1)
    total_iters = iters_per_epoch * cfg.solver.total_epochs
    logger.info(f"{n_records} records, {iters_per_epoch} iters/epoch, "
                f"{total_iters} total iters")

    trainer = Trainer(cfg, model, total_iters, device=device)
    start = trainer.resume() if args.resume else 0

    # ONE device frame cache for the main and TRAIN2 loaders (keys are rgb
    # paths, unique across splits)
    dev_cache = DeviceFrameCache(cfg.data.device_frame_cache_mb << 20,
                                 device) \
        if cfg.data.device_frame_cache_mb > 0 else None

    def device_batches(split_name, seed: int = 0):
        for gb in train_group_iterator(
                cfg, split_name, seed=seed, cache_dir=cache_dir,
                frame_bucket=cfg.data.frame_bucket,
                yield_keys=dev_cache is not None):
            if dev_cache is not None:
                frames = dev_cache.stack(gb["frame_slots"])
            else:
                frames = widen_depth(upload_frame(gb["frames"], device))
            yield {"frames": frames, "rois": gb["rois"]}

    loader2 = None
    if cfg.data.train2_datasets and cfg.data.train2_ratio > 0:
        loader2 = device_batches(list(cfg.data.train2_datasets), seed=1)

    eval_fn = None
    if cfg.train.eval_period > 0 and cfg.data.test_datasets:
        from .engine.eval_runner import run_eval

        # the live model's own precision, as the JAX package evaluates it:
        # bf16 autocast with solver.amp, float32 without
        eval_dtype = torch.bfloat16 if cfg.solver.amp else torch.float32

        def eval_fn(state, it):
            for test_split in cfg.data.test_datasets:
                run_eval(cfg, ckpt_dir="", split_name=test_split,
                         model=state.model, dtype=eval_dtype)

    with _profiled(args.profile, os.path.join(out_dir, "profile")):
        state = trainer.train(
            device_batches(split), start_iter=start, loader2=loader2,
            train2_ratio=cfg.data.train2_ratio, eval_fn=eval_fn,
            aux_metrics_fn=dev_cache.stats if dev_cache is not None
            else None)
    logger.info("training complete")
    return state


if __name__ == "__main__":
    main()
