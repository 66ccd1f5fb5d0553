"""Evaluate a checkpoint on a test split.

Counterpart of ``tools/eval_split.py`` (the reference's test_gdrn.sh ->
main_gdrn.py --eval-only): a thin CLI over
``rdpn6d_tpu_torch.engine.eval_runner.run_eval``.

Usage:
  python -m rdpn6d_tpu_torch.tools.eval_split \\
      --config-file rdpn6d_tpu_torch/configs/lm13.py \\
      --ckpt-dir output/lm13/ckpt --split lm_13_test \\
      [--dets detections.json] [--csv result.csv] [--json metrics.json] \\
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import logging


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--split", required=True)
    p.add_argument("--dets", default="",
                   help="external detections json (est-bbox eval)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--csv", default="")
    p.add_argument("--json", default="",
                   help="write the metric dict to this json file "
                        "(machine-readable gate for rehearsal/CI)")
    p.add_argument("--opts", nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from ..config import load_config
    from ..engine.eval_runner import run_eval
    from ..utils.device import resolve_device

    cfg = load_config(args.config_file, args.opts)
    result = run_eval(cfg, args.ckpt_dir, args.split, dets_path=args.dets,
                      batch_size=args.batch_size,
                      csv_path=args.csv or None,
                      device=resolve_device(args.device))
    if args.json:
        # the JAX package's metric dict: the per-object error arrays the
        # port's run_eval adds are no metric
        metrics = {k: v for k, v in result.items() if k != "errors"}
        with open(args.json, "w") as f:
            json.dump(_plain(metrics), f, indent=2)
    return result


if __name__ == "__main__":
    main()
