#!/usr/bin/env python3
"""The conditioning of the served ``test.use_pnp`` refits that
``chip_smoke.py`` phase 16(b) holds the ``ransac_kabsch`` kernel to its
plain version on.

    python3 ransac_conditioning.py [--reps 5]

Serves phase 3's frames (lm13 at full width, seeded weights, float32, TF32
off) with ``test.use_pnp=true`` on one CUDA card ``--reps`` times and, for
every ROI whose best hypothesis the kernel and the plain version agree on
and whose R differs by more than 1e-5, prints: the kernel's and the plain
version's R distance to each other and to a float64 refit on the plain
version's inlier weights, the inlier count, and the singular values of
the refit's covariance (near rank 1: the rotation about the line the
inliers lie on is not determined in float32).
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ransac_conditioning: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from rdpn6d_tpu_torch.configs import lm13
    from rdpn6d_tpu_torch.engine.predictor import Predictor
    from rdpn6d_tpu_torch.ops import cuda_build
    from rdpn6d_tpu_torch.ops import ransac_kabsch as rk

    for k in ("roi_crop", "ransac_kabsch", "min_dist2"):
        cuda_build.build(k)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = lm13.get_config().apply_opts(['head.init="fan_in"',
                                        "test.use_pnp=true"])
    pred = cs.physical_z(Predictor(
        cfg, cs.lm_assets(cfg.head.num_regions, 4096, seed=1),
        batch_size=cs.SERVE_BATCH, dtype=torch.float32, device="cuda",
        allow_random_init=True))
    frames = cs.make_frames(seed=2)
    print(f"card: {cs.nvidia_smi('name,power.limit')}")
    for rep in range(args.reps):
        cs.serve(pred, frames)
        with cs.RansacCalls() as rc:
            cs.serve(pred, frames)
        for c, (a, out) in enumerate(rc.calls):
            ref = rk.ransac_kabsch_plain(*a)
            w = cs.refit_weights(*a)
            R64, _ = rk.kabsch(a[0].double(), a[1].double(), w.double())
            for i in range(ref.R.shape[0]):
                if int(out.best[i]) != int(ref.best[i]) \
                        or bool(ref.R[i].isnan().any()):
                    continue
                d = float((out.R[i] - ref.R[i]).abs().max())
                if d <= 1e-5:
                    continue
                dk = float((out.R[i].double() - R64[i]).abs().max())
                dp = float((ref.R[i].double() - R64[i]).abs().max())
                _, _, cov = rk._centred(a[0][i].double(), a[1][i].double(),
                                        w[i].double(), 1e-8)
                sv = torch.linalg.svdvals(cov).cpu().numpy()
                print(f"rep {rep} batch {c} ROI {i}: kernel-plain {d:.3e}; "
                      f"kernel-f64 {dk:.3e}, plain-f64 {dp:.3e}; inliers "
                      f"{int(w[i].sum())}, refit covariance singular values "
                      f"{sv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
