"""Full-protocol rehearsal: a generated mini-BOP through the port's CLI chain.

Counterpart of ``tools/rehearse_protocol.py``: proves that the assembled
on-disk protocol, not just its parts, gives a sane number. Every step is
the port's own entry point, run as a subprocess with ``RDPN6D_DATA_ROOT``
at the generated tree:

    1. tools.make_mini_bop          render the dataset (host rasterizer)
    2. tools.compute_fps            FPS keypoints -> models/fps_points.pkl
    3. tools.gen_xyz_crop           GT NOCS crops of the train split
    4. python -m rdpn6d_tpu_torch.main   train (configs/mini.py)
    5. tools.eval_split             GT-box eval -> metrics + BOP CSV
    6. tools.eval_split --dets      est-box eval (jittered dets + misses)
    7. tools.score_csv --bop19      the cached CSV rescored, a cross-check

``--device`` goes to every step that computes on one (4-7).

Usage:
  python -m rdpn6d_tpu_torch.tools.rehearse_protocol --root DATA --run OUT \\
      [--epochs 120] [--device cuda] [--gate]

``--gate`` asserts the accuracy bars (GT-box ad_10 >= 95, est-box ad_10
>= 70, the BOP19 ARs in [0.5, 1]) and exits non-zero on failure.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join("rdpn6d_tpu_torch", "configs", "mini.py")


def parse_bop19_line(out: str) -> dict[str, float]:
    """The last ``BOP19: {...}`` dict printed by ``tools.score_csv``."""
    ars: dict[str, float] = {}
    for line in out.splitlines():
        if line.startswith("BOP19:"):
            ars = ast.literal_eval(line.split("BOP19:", 1)[1].strip())
    return ars


def rescore_consistent(est_ars: dict, rescore_ars: dict,
                       tol: float = 0.05) -> bool:
    """The cached CSV's AR must agree with the in-process AR: the same
    scorer runs twice, but the CSV round-trips R/t through text, so a mm/m
    or transpose bug in the CSV path collapses the AR. ``tol`` lets one
    threshold-straddling match flip on a tiny test set."""
    common = set(rescore_ars) & set(est_ars)
    return bool(common) and all(
        abs(rescore_ars[k] - est_ars[k]) <= tol for k in common)


def run(cmd: list[str], env: dict, log: str = "") -> str:
    print(f"+ {' '.join(cmd)}", flush=True)
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True)
    if log:
        with open(log, "w") as f:
            f.write(proc.stdout + "\n=== stderr ===\n" + proc.stderr)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-3000:] + "\n" + proc.stderr[-6000:])
        raise SystemExit(f"step failed ({proc.returncode}): {cmd}")
    return proc.stdout + proc.stderr


def tool(name: str) -> list[str]:
    return [sys.executable, "-m", f"rdpn6d_tpu_torch.tools.{name}"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True, help="dataset dir to generate")
    p.add_argument("--run", required=True, help="training output dir")
    p.add_argument("--n-train", type=int, default=60)
    p.add_argument("--n-test", type=int, default=10)
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--device", default="cuda",
                   help="the device of the train, eval and score steps")
    p.add_argument("--skip-make", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="pass --resume to main: continue training from the "
                        "newest checkpoint in the run dir")
    p.add_argument("--skip-train", action="store_true",
                   help="reuse an existing checkpoint in --run")
    p.add_argument("--gate", action="store_true")
    p.add_argument("--obj", default="",
                   help="single-object (SO) rehearsal: train and eval only "
                        "this object through the lm_mini_<obj>_* splits")
    p.add_argument("--eval-train", action="store_true",
                   help="also GT-box-eval the TRAIN split: separates 'eval "
                        "path broken' (train also scores 0) from 'model "
                        "undertrained' (train >> test)")
    p.add_argument("--opts", nargs="*", default=[],
                   help="extra config opts forwarded to train/eval")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    env = dict(os.environ)
    env["RDPN6D_DATA_ROOT"] = os.path.abspath(args.root)
    dev = ["--device", args.device]
    os.makedirs(args.run, exist_ok=True)

    if not args.skip_make:
        run(tool("make_mini_bop") + ["--out", args.root,
                                     "--n-train", str(args.n_train),
                                     "--n-test", str(args.n_test)], env)
    run(tool("compute_fps") + ["--dataset", "lm", "--objs", "ape", "can",
                               "driller"], env)
    run(tool("gen_xyz_crop") + ["--split", "lm_mini_train"], env)

    tr_split = f"lm_mini_{args.obj}_train" if args.obj else "lm_mini_train"
    te_split = f"lm_mini_{args.obj}_test" if args.obj else "lm_mini_test"
    opts = [f'train.output_dir="{args.run}"',
            f"solver.total_epochs={args.epochs}",
            f'data.train_datasets=["{tr_split}"]',
            f'data.test_datasets=["{te_split}"]', *args.opts]
    ckpt = os.path.join(args.run, "ckpt")
    if not args.skip_train:
        resume = ["--resume"] if args.resume else []
        run([sys.executable, "-m", "rdpn6d_tpu_torch.main", "--config-file",
             CONFIG, *resume, *dev, "--opts", *opts], env,
            log=os.path.join(args.run, "train_log.txt"))

    gt_json = os.path.join(args.run, "metrics_gt_bbox.json")
    run(tool("eval_split") + ["--config-file", CONFIG, "--ckpt-dir", ckpt,
                              "--split", te_split, "--json", gt_json,
                              "--csv", os.path.join(args.run, "gt_bbox.csv"),
                              *dev, "--opts", *opts], env,
        log=os.path.join(args.run, "eval_gt_log.txt"))

    est_json = os.path.join(args.run, "metrics_est_bbox.json")
    est_csv = os.path.join(args.run, "est_bbox.csv")
    dets = os.path.join(env["RDPN6D_DATA_ROOT"], "lm",
                        "detections_mini.json")
    run(tool("eval_split") + ["--config-file", CONFIG, "--ckpt-dir", ckpt,
                              "--split", te_split, "--dets", dets,
                              "--json", est_json, "--csv", est_csv, *dev,
                              "--opts", *opts], env,
        log=os.path.join(args.run, "eval_est_log.txt"))

    rescore_out = run(tool("score_csv") + ["--csv", est_csv, "--split",
                                           te_split, "--bop19", *dev], env,
                      log=os.path.join(args.run, "rescore_log.txt"))

    train_mean = None
    if args.eval_train:
        tr_json = os.path.join(args.run, "metrics_train_split.json")
        run(tool("eval_split") + [
            "--config-file", CONFIG, "--ckpt-dir", ckpt, "--split",
            tr_split, "--json", tr_json, "--csv",
            os.path.join(args.run, "train_bbox.csv"), *dev, "--opts", *opts,
            'test.error_types="ad,adi,re,te,proj"'], env,
            log=os.path.join(args.run, "eval_train_log.txt"))
        with open(tr_json) as f:
            train_mean = json.load(f)["mean"]

    with open(gt_json) as f:
        gt = json.load(f)
    with open(est_json) as f:
        est = json.load(f)

    rescore_ars = parse_bop19_line(rescore_out)
    est_ars = est.get("bop19", {})
    rescore_ok = rescore_consistent(est_ars, rescore_ars)

    summary = {
        "gt_ad_10": gt["mean"].get("ad_10", 0.0),
        "gt_te_2": gt["mean"].get("te_2", 0.0),
        "gt_re_5": gt["mean"].get("re_5", 0.0),
        "gt_per_obj_ad_10": {o: v.get("ad_10", 0.0)
                             for o, v in gt["per_obj"].items()},
        "est_ad_10": est["mean"].get("ad_10", 0.0),
        "est_bop19": est_ars,
        "rescore_bop19": rescore_ars,
        "rescore_ran": rescore_ok,
    }
    if train_mean is not None:
        summary["train_split"] = {k: train_mean.get(k, 0.0)
                                  for k in ("ad_10", "adi_10", "re_10",
                                            "te_2")}
    print("REHEARSAL_SUMMARY " + json.dumps(summary), flush=True)
    with open(os.path.join(args.run, "rehearsal_summary.json"),
              "w") as f:
        json.dump(summary, f, indent=2)

    if args.gate:
        ars = {k: v for k, v in summary["est_bop19"].items()
               if k.upper().startswith("AR")}
        ok = (summary["gt_ad_10"] >= 95.0
              and summary["est_ad_10"] >= 70.0
              and summary["rescore_ran"]
              and bool(ars)  # the AR bar must actually gate something
              and all(0.5 <= v <= 1.0 for v in ars.values()))
        if not ok:
            raise SystemExit(f"GATE FAILED: {summary}")
        print("GATE PASSED")
    return summary


if __name__ == "__main__":
    main()
