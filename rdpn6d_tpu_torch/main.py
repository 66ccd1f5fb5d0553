"""CLI entry: evaluate a config's checkpoint on its test splits.

    python -m rdpn6d_tpu_torch.main --config-file CFG --eval-only
        [--device cuda|cpu] [--opts k=v ...]

Counterpart of ``rdpn6d_tpu/main.py``'s ``--eval-only`` branch: dumps the
config to ``<output_dir>/config.json`` and runs ``run_eval`` on each of
``data.test_datasets`` with the latest checkpoint in ``<output_dir>/ckpt``
(the port's format, ``engine/checkpoint.py``), writing the per-object
table to the log, ``<split>_bop19.csv``, the recall curves under
``plots_<split>/`` and, with a targets file and mssd/mspd asked for, the
BOP19 AR. It runs on ``cuda`` unless ``--device`` names another device.
Training (no ``--eval-only``), ``--debug`` and ``--multihost`` are not
ported and raise.
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--profile", action="store_true")
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


def main(argv=None) -> dict:
    """Returns {split: run_eval's result} for each test split."""
    args = parse_args(argv)
    if args.multihost:
        raise NotImplementedError("--multihost: multi-process runs are not "
                                  "ported (ROADMAP: DDP)")
    if not args.eval_only:
        raise NotImplementedError("training from the CLI is not ported "
                                  "(ROADMAP queue 1 item 11); pass "
                                  "--eval-only")
    if args.debug:
        raise NotImplementedError("--debug: the coordinate-regression eval "
                                  "is not ported (ROADMAP queue 1 item 11)")
    from .config import load_config
    from .engine.eval_runner import run_eval
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.config_file, args.opts)
    if cfg.train.output_dir == "auto":
        cfg = cfg.apply_opts(
            [f'train.output_dir="{auto_output_dir(args.config_file)}"'])
    setup_logging(cfg.train.output_dir)
    logger = logging.getLogger("rdpn6d")
    cfg.dump(os.path.join(cfg.train.output_dir, "config.json"))
    logger.info(f"device: {device}")
    return {split: run_eval(cfg, ckpt_dir=f"{cfg.train.output_dir}/ckpt",
                            split_name=split, device=device)
            for split in cfg.data.test_datasets}


if __name__ == "__main__":
    main()
