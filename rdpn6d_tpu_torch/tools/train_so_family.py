"""Sweep a single-object (SO) family: train (or evaluate) one model per
object of a dataset through ``configs/so.py`` variants.

Counterpart of ``tools/train_so_family.py``. The reference ships one config
file per object and users launch them one by one; this drives the whole
family, one object after another in this process, through
``rdpn6d_tpu_torch.main``:

    python -m rdpn6d_tpu_torch.tools.train_so_family --dataset mp6d
    python -m rdpn6d_tpu_torch.tools.train_so_family --dataset tudl \\
        --objs dragon can --eval-only --opts solver.ims_per_batch=48

An object that fails is reported at the end and the sweep goes on; the exit
code is 1 if any failed.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

SO_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "so.py")


def family_objects(dataset: str, objs=None) -> list[str]:
    """The objects of the sweep: ``objs``, else every object of the
    dataset (lm without bowl and cup, which LM-13 leaves out)."""
    from ..data.refs import get_ref

    if objs:
        return list(objs)
    ref = get_ref(dataset)
    if dataset == "lm":
        return [o for o in ref.objects if o not in ("bowl", "cup")]
    return list(ref.objects)


def object_argv(dataset: str, obj: str, eval_only: bool = False,
                resume: bool = False, opts=(), device: str = "cuda"
                ) -> list[str]:
    """``main``'s argv for one object of the family."""
    argv = ["--config-file", f"{SO_CONFIG}:{dataset}/{obj}"]
    if eval_only:
        argv.append("--eval-only")
    if resume:
        argv.append("--resume")
    argv += ["--device", device]
    if opts:
        argv += ["--opts", *opts]
    return argv


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", required=True,
                   help="SO family: lm | lmo | ycbv | mp6d | tless | "
                        "tudl | itodd | icbin | hb")
    p.add_argument("--objs", nargs="*", default=None,
                   help="subset of object names (default: all)")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--opts", nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..main import main as run_main

    objs = family_objects(args.dataset, args.objs)
    logging.basicConfig(level=logging.INFO)
    failures = []
    for i, obj in enumerate(objs):
        print(f"=== [{i + 1}/{len(objs)}] {args.dataset}SO/{obj} ===",
              flush=True)
        try:
            run_main(object_argv(args.dataset, obj, args.eval_only,
                                 args.resume, args.opts, args.device))
        except Exception as e:  # keep sweeping; report at the end
            logging.exception(f"{obj} failed")
            failures.append((obj, repr(e)))
    if failures:
        print("FAILED objects:")
        for obj, err in failures:
            print(f"  {obj}: {err}")
        sys.exit(1)
    print(f"all {len(objs)} objects completed")


if __name__ == "__main__":
    main()
