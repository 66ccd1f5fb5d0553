"""Multi-seed int8 accuracy-gate sweep and per-stage sensitivity table.

Counterpart of ``tools/int8_gate_sweep.py``. Each seed is a fresh scene
render, a fresh model init and a fresh 300-step train
(``python -m rdpn6d_tpu_torch.tools.overfit_synth --seed S --int8
--int8-stages``), run in a subprocess so that no state leaks across seeds.
The table of every mode's mean [min-max] over the seeds goes to stdout,
bf16 included as the noise floor; the raw per-seed JSON to ``--out``.

Usage: python -m rdpn6d_tpu_torch.tools.int8_gate_sweep --seeds 3 \\
    [--mesh tetra] [--out int8_sweep.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# values may be "nan" on a degenerate eval: parse them rather than drop the
# whole RESULT line (a dropped tag would fail the aggregation after every
# seed had run)
_NUM = r"(?:[\d.]+|nan|inf)"
RESULT_RE = re.compile(
    r"RESULT\[(?P<tag>[^\]]+)\] ad_10=(?P<ad_10>%s) "
    r"re_5=(?P<re_5>%s) te_2=(?P<te_2>%s) AUCad=(?P<AUCad>%s)"
    % (_NUM, _NUM, _NUM, _NUM))
METRICS = ("ad_10", "re_5", "te_2", "AUCad")


def run_seed(seed: int, mesh: str, workdir: str,
             device: str = "cuda") -> dict[str, dict]:
    cmd = [sys.executable, "-m", "rdpn6d_tpu_torch.tools.overfit_synth",
           "--mesh", mesh, "--int8", "--int8-stages", "--seed", str(seed),
           "--out", os.path.join(workdir, f"seed{seed}"),
           "--device", device]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=2400,  # a hung seed must not block
                          cwd=REPO)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-2000:])
        raise RuntimeError(f"seed {seed} failed rc={proc.returncode}")
    out: dict[str, dict] = {}
    for m in RESULT_RE.finditer(proc.stdout):
        out[m.group("tag")] = {k: float(m.group(k)) for k in METRICS}
    if not out:
        raise RuntimeError(f"seed {seed}: no RESULT lines parsed")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--mesh", default="tetra",
                   help="tetra = asymmetric, the rotation-sensitive rig")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "int8_sweep.json"))
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                     "int8_sweep"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    per_seed = {}
    for s in range(args.seeds):
        per_seed[s] = run_seed(s, args.mesh, args.workdir, args.device)
        print(f"seed {s} done: "
              + ", ".join(f"{t}:re_5={v['re_5']:.1f}"
                          for t, v in per_seed[s].items()))

    # the union of tags in first-seen order, tolerant of a seed missing
    # one (a crashed or unparsed mode): aggregate over the seeds with it
    tags = list(dict.fromkeys(
        t for res in per_seed.values() for t in res))
    print(f"\n{args.seeds}-seed gate sweep ({args.mesh}):")
    print(f"{'mode':>18} | " + " | ".join(f"{k:>16}" for k in METRICS))
    agg = {}
    for t in tags:
        row = {}
        have = [s for s in per_seed if t in per_seed[s]]
        if len(have) < len(per_seed):
            print(f"WARNING: {t} present in only {len(have)}/"
                  f"{len(per_seed)} seeds")
        for k in METRICS:
            vals = [per_seed[s][t][k] for s in have]
            row[k] = {"mean": sum(vals) / len(vals), "min": min(vals),
                      "max": max(vals)}
        agg[t] = row
        print(f"{t:>18} | " + " | ".join(
            f"{row[k]['mean']:6.1f} [{row[k]['min']:5.1f}-"
            f"{row[k]['max']:5.1f}]" for k in row))

    with open(args.out, "w") as f:
        json.dump({"mesh": args.mesh, "seeds": args.seeds,
                   "per_seed": {str(k): v for k, v in per_seed.items()},
                   "aggregate": agg}, f, indent=1)
    print(f"\nraw -> {args.out}")
    return agg


if __name__ == "__main__":
    main()
