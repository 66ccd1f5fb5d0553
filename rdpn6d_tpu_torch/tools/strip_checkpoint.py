"""Strip the optimizer state from a checkpoint for release.

Counterpart of ``tools/strip_checkpoint.py`` (the reference's
tools/remove_optim_from_ckpt.py:18-41): load a step of the port's
checkpoint directory (``engine/checkpoint.py``), drop the optimizer state,
and write ``<out>/<step>/state.pt`` (a checkpoint directory that
``Predictor(ckpt_dir=...)`` and ``main --eval-only`` read) with the
content hash as a file-name suffix beside it,
``<out>/model_<step>_<sha256[:8]>.pt`` (a hard link to the same bytes).

Usage: python -m rdpn6d_tpu_torch.tools.strip_checkpoint \\
    --ckpt-dir output/ckpt --out release/ [--step N]
"""

from __future__ import annotations

import argparse
import hashlib
import io
import os
import shutil


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--step", type=int, default=-1)
    args = p.parse_args(argv)

    import torch

    from ..engine.checkpoint import STATE_FILE, CheckpointManager

    mgr = CheckpointManager(args.ckpt_dir)
    step = args.step if args.step >= 0 else mgr.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoint found in {args.ckpt_dir}")
    src = os.path.join(mgr.directory, str(step), STATE_FILE)
    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    buf = io.BytesIO()
    torch.save({"model": ckpt["model"], "optimizer": None, "step": step},
               buf)
    blob = buf.getvalue()
    sha = hashlib.sha256(blob).hexdigest()[:8]
    step_dir = os.path.join(args.out, str(step))
    os.makedirs(step_dir, exist_ok=True)
    out_path = os.path.join(step_dir, STATE_FILE)
    with open(out_path, "wb") as f:
        f.write(blob)
    named = os.path.join(args.out, f"model_{step}_{sha}.pt")
    if os.path.exists(named):
        os.remove(named)
    try:
        os.link(out_path, named)
    except OSError:            # a file system without hard links
        shutil.copyfile(out_path, named)
    print(f"wrote {named} ({len(blob) / 1e6:.1f} MB)")
    return named


if __name__ == "__main__":
    main()
