"""CLI entry: train a config, or evaluate its checkpoint.

    python -m rdpn6d_tpu_torch.main --config-file CFG [--eval-only]
        [--resume] [--profile] [--device cuda|cpu] [--num-devices N]
        [--multihost --dist-coordinator HOST:PORT --num-processes P
         --process-id R] [--opts k=v ...]

Counterpart of ``rdpn6d_tpu/main.py``. Both branches dump the config to
``<output_dir>/config.json`` and log to ``<output_dir>/log.txt``.

Data parallelism (``parallel/mesh.py``): ``--num-devices N`` runs N
processes on this host, rank i on ``cuda:i`` over NCCL (0, the default,
takes every visible card; more than are visible raises), or with
``--device cpu`` N gloo processes on the CPU; where
``solver.ims_per_batch`` does not divide by N, gcd(N, ims_per_batch)
processes run. ``--multihost`` instead joins this process, as rank R of
P, to a group through the coordinator's address; it drives one card
(``cuda:<R mod visible cards>``), and ``ims_per_batch`` must divide by P.
``ims_per_batch`` is the global batch: each rank trains on its share,
evaluates its frame shard, and rank 0 writes the metrics, checkpoints,
tables and CSV (rank r > 0 logs to ``log.txt.rank<r>``). A run of N > 1
spawned processes returns rank 0's eval results for ``--eval-only`` and
None for training.

Training (no ``--eval-only``): the records of ``data.train_datasets`` give
the iterations (``solver.total_epochs`` x records // ``ims_per_batch``);
the trunk loads ``backbone.pretrained`` (skipped when ``--resume`` finds a
checkpoint); batches come from the frame-grouped decode pool through one
shared ``DeviceFrameCache`` (``data.device_frame_cache_mb``), or with
``data.grouped_train=false`` from the flat per-instance pool (full float32
frames a ROI, no device cache, as in the JAX package), with TRAIN2
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
a targets file and mssd/mspd asked for, the BOP19 AR. With ``--debug`` it
runs the coordinate-regression debug eval instead
(``eval_runner.coord_regression_eval``: the masked L1 of the predicted
against the GT coordinates, logged and returned per split).

Everything runs on ``cuda`` unless ``--device`` names another device.
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
                        "(the masked coordinate L1)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--num-devices", type=int, default=0,
                   help="0 = all visible devices")
    p.add_argument("--multihost", action="store_true",
                   help="join a process group of --num-processes ranks "
                        "as --process-id through --dist-coordinator")
    p.add_argument("--dist-coordinator", default="",
                   help="host:port of rank 0 (with --multihost)")
    p.add_argument("--num-processes", type=int, default=0,
                   help="total process count (with --multihost)")
    p.add_argument("--process-id", type=int, default=-1,
                   help="this process's rank (with --multihost)")
    p.add_argument("--profile", action="store_true",
                   help="trace the training loop with torch.profiler into "
                        "<output_dir>/profile")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--opts", nargs="*", default=[])
    return p.parse_args(argv)


def setup_logging(output_dir: str) -> None:
    """INFO to the console and ``<output_dir>/log.txt``; a rank r > 0 of a
    process group logs to ``log.txt.rank<r>`` and only warnings to the
    console."""
    from .parallel import mesh

    os.makedirs(output_dir, exist_ok=True)
    r = mesh.rank()
    console = logging.StreamHandler()
    if r:
        console.setLevel(logging.WARNING)
    name = f"log.txt.rank{r}" if r else "log.txt"
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        handlers=[console,
                  logging.FileHandler(os.path.join(output_dir, name))],
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
    trace, ``trace.json``; rank r > 0's ``trace.rank<r>.json``), or
    nothing."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    os.makedirs(trace_dir, exist_ok=True)
    from .parallel import mesh

    with profile(activities=acts) as prof:
        yield
    r = mesh.rank()
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace.rank{r}.json" if r else "trace.json"))


def main(argv=None):
    """Training returns the final ``TrainState``; ``--eval-only`` returns
    {split: run_eval's result} for each test split (rank 0's full result,
    another rank's ``{"stats"}``). N > 1 spawned processes: the module
    docstring."""
    args = parse_args(argv)
    from .parallel import mesh
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    if args.multihost:
        device = _join_group(args, device)
        try:
            return run(args, device)
        finally:
            mesh.close_group()
    n = _local_processes(args, device)
    if n > 1:
        return mesh.spawn(_spawned_rank, n, args=(args,),
                          device=device.type)[0]
    return run(args, device)


def _spawned_rank(device, args):
    out = run(args, device)
    return out if args.eval_only else None


def _local_processes(args, device) -> int:
    """The processes of a single-host run: ``--num-devices`` (0: every
    visible card, one process on the CPU), cut to gcd(N, ims_per_batch)
    where ``ims_per_batch`` does not divide by N."""
    import math

    import torch

    from .config import load_config

    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    n = args.num_devices or visible
    if device.type == "cuda" and n > visible:
        raise ValueError(f"--num-devices={n} but {visible} CUDA "
                         "device(s) are visible")
    if n > 1 and device.index is not None:
        raise ValueError(f"--num-devices={n} with one named card "
                         f"{str(device)!r}: pass --device cuda")
    ims = load_config(args.config_file, args.opts).solver.ims_per_batch
    if ims % n:
        m = math.gcd(n, ims)
        logging.getLogger("rdpn6d").warning(
            f"ims_per_batch={ims} not divisible by {n} processes; "
            f"running {m}")
        n = m
    return n


def _join_group(args, device):
    """``--multihost``: join the group as ``--process-id`` and return this
    process's device."""
    import torch

    from .config import load_config
    from .parallel import mesh

    if not args.dist_coordinator or args.num_processes < 1 \
            or not 0 <= args.process_id < args.num_processes:
        raise ValueError("--multihost needs --dist-coordinator host:port, "
                         "--num-processes P and --process-id in [0, P)")
    if args.num_devices > 1:
        raise ValueError("--num-devices with --multihost: each process "
                         "drives one card")
    ims = load_config(args.config_file, args.opts).solver.ims_per_batch
    if ims % args.num_processes:
        raise ValueError(f"ims_per_batch={ims} must be divisible by the "
                         f"{args.num_processes} processes of a multi-host "
                         "run")
    if device.type == "cuda" and device.index is None:
        device = torch.device(
            "cuda", args.process_id % torch.cuda.device_count())
    return mesh.init_distributed(args.process_id, args.num_processes,
                                 f"tcp://{args.dist_coordinator}", device)


def run(args, device):
    """The run of one process (of a group or alone) on ``device``."""
    from .config import load_config
    from .parallel import mesh

    cfg = load_config(args.config_file, args.opts)
    if cfg.train.output_dir == "auto":
        cfg = cfg.apply_opts(
            [f'train.output_dir="{auto_output_dir(args.config_file)}"'])
    setup_logging(cfg.train.output_dir)
    logger = logging.getLogger("rdpn6d")
    if mesh.is_main():
        cfg.dump(os.path.join(cfg.train.output_dir, "config.json"))
    logger.info(f"device: {device}, rank {mesh.rank()} of {mesh.world()}")
    if args.eval_only:
        from .engine.eval_runner import coord_regression_eval, run_eval

        evaluate = coord_regression_eval if args.debug else run_eval
        return {split: evaluate(cfg, ckpt_dir=f"{cfg.train.output_dir}/ckpt",
                                split_name=split, device=device)
                for split in cfg.data.test_datasets}
    return train(cfg, args, device, logger)


def train(cfg, args, device, logger):
    """The train branch of ``main``."""
    import torch

    from .data.device_cache import DeviceFrameCache, upload_frame, \
        widen_depth
    from .data.loader import load_train_records, train_frame_iterator, \
        train_group_iterator
    from .engine.checkpoint import CheckpointManager
    from .engine.trainer import Trainer
    from .models import RDPN, init_weights
    from .parallel import mesh

    out_dir = cfg.train.output_dir
    if cfg.solver.ims_per_batch % mesh.world():
        raise ValueError(f"ims_per_batch={cfg.solver.ims_per_batch} not "
                         f"divisible by {mesh.world()} processes")
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
    # paths, unique across splits); the flat path has none
    grouped = cfg.data.grouped_train
    dev_cache = DeviceFrameCache(cfg.data.device_frame_cache_mb << 20,
                                 device) \
        if grouped and cfg.data.device_frame_cache_mb > 0 else None

    def device_batches(split_name, seed: int = 0):
        if not grouped:
            for samples in train_frame_iterator(cfg, split_name, seed=seed,
                                                cache_dir=cache_dir):
                yield {"samples": samples}
            return
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
