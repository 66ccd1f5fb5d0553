"""int8 serving-mode timing: bf16 against dynamic and calibrated int8.

Counterpart of ``tools/bench_int8.py``. Times the whole eval forward at a
serving batch size in each mode: ``bf16``, ``head`` / ``all`` (W8A8 with
dynamic activation scales) and ``head-static`` / ``all-static`` (scales
calibrated on one batch by ``models/quant.calibrate_quant``). Each mode is
``RDPN(cfg, int8=..., int8_static=...)`` with the same seeded weights,
run through ``parallel.make_eval_step`` under bf16 autocast over float32
parameters, the JAX tool's bf16 compute over float32 params; the int8
modes launch ``int8_conv``, ``quantize_act`` and ``bn_relu_quantize`` on a
card. Distinct inputs every iteration, a value read back every iteration,
warm-up excluded. Prints a JSON line a mode.

Usage: python -m rdpn6d_tpu_torch.tools.bench_int8 [--batch 256]
    [--iters 10] [--modes bf16 head head-static all all-static]
    [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def build(cfg, mode: str, state_dict: dict, device: torch.device,
          calib: dict):
    """The eval-mode model of ``mode`` on ``device`` with ``state_dict``,
    a static mode calibrated on ``calib`` under bf16 autocast."""
    from ..models import RDPN
    from ..models.quant import calibrate_quant

    if mode == "bf16":
        int8, static = False, False
    elif mode.endswith("-static"):
        int8, static = mode[:-len("-static")], True
    else:
        int8, static = mode, False
    model = RDPN(cfg, int8=int8, int8_static=static)
    model.load_state_dict(state_dict)
    model = model.to(device).eval()
    if static:
        with torch.autocast(device.type, dtype=torch.bfloat16):
            calibrate_quant(model, [calib])
    return model


def run(args, cfg=None) -> list[dict]:
    """Each mode of ``args.modes`` in turn: print and return its JSON
    line's dict. ``cfg`` defaults to the flagship ``Config()``."""
    from ..config import Config
    from ..data.synthetic import dummy_batch
    from ..models import RDPN, init_weights
    from ..parallel import make_eval_step
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = Config() if cfg is None else cfg
    bs = args.batch
    host = dummy_batch(cfg, bs)
    rng = np.random.RandomState(0)
    host["roi_img"] = rng.rand(*host["roi_img"].shape).astype(np.float32)
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    imgs = [torch.from_numpy(rng.rand(*host["roi_img"].shape)
                             .astype(np.float32)).to(device)
            for _ in range(4)]
    weights = init_weights(RDPN(cfg), torch.Generator().manual_seed(0)) \
        .state_dict()

    results, lines = {}, []
    for mode in args.modes:
        model = build(cfg, mode, weights, device, batch)
        step = make_eval_step(cfg, model, autocast=torch.bfloat16)

        def run_once(i):
            b = dict(batch)
            b["roi_img"] = imgs[i % len(imgs)] + (i * 1e-6)
            return step(b)

        for i in range(args.warmup):
            float(run_once(i)["trans"].sum())
        t0 = time.perf_counter()
        for i in range(args.iters):
            float(run_once(i + 7)["trans"].sum())      # value readback
        dt = (time.perf_counter() - t0) / args.iters
        results[mode] = dt
        line = {
            "mode": mode, "batch": bs,
            "ms_per_batch": dt * 1000,
            "poses_per_sec": bs / dt,
            "vs_bf16": results.get("bf16", dt) / dt,
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--modes", nargs="*",
                   default=["bf16", "head", "head-static", "all",
                            "all-static"])
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
