"""Train-mode against eval-mode forward of the two BatchNorm-heavy modules.

Counterpart of ``tools/bench_bn.py``: times the flagship's trunk and dense
head alone, each in train mode (batch-statistics BatchNorm, running
statistics moved) and in eval mode, so that the train-vs-eval forward
gap is placed in a module before anyone fixes it:

  * ``ResNetTrunk(34)`` on 6-channel 256² input (33 BN layers; the stem
    widened to 6 channels as the JAX tool's trunk takes them), and with
    ``--s2d`` the space-to-depth stem on 6 channels and both stems on the
    RGB half the model's trunk really takes;
  * ``DenseHead`` on the 32² x 1024 fused input (7 BN layers at 64² x
    256).

Forward only, no gradients, bf16 autocast over float32 parameters (the
train step's precision), on ``--device``. Distinct inputs every
iteration, a value read back every iteration, warm-up excluded. Prints a
JSON line a module and mode; ``mfu_pct`` counts the convolutions'
FLOPs (``utils.profiling.count_flops``) over the card's dense bf16 peak
(``utils.profiling.bf16_peak_flops``), null on the CPU or an unknown
card.

Usage: python -m rdpn6d_tpu_torch.tools.bench_bn [--batch 192]
    [--iters 12] [--s2d] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch import nn


def trunk(in_channels: int, s2d: bool, depth: int = 34) -> nn.Module:
    """The port's ResNet trunk with its stem taking ``in_channels``."""
    from ..models.resnet import ResNetTrunk

    m = ResNetTrunk(depth, s2d_stem=s2d)
    if in_channels != 3:
        m.conv1 = nn.Conv2d(4 * in_channels, 64, 4, 1, 0, bias=False) \
            if s2d else nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
    return m


def modules(s2d: bool, depth: int = 34, res: int = 256,
            head_res: int = 32, head_in: int = 1024,
            num_filters: int = 256
            ) -> list[tuple[str, nn.Module, tuple[int, ...]]]:
    """(name, module, input shape NCHW without the batch) in the JAX
    tool's order; the sizes default to the flagship's."""
    from ..models.heads import DenseHead

    out = [(f"trunk_r{depth}_{res}px", trunk(6, False, depth),
            (6, res, res))]
    if s2d:
        out += [(f"trunk_r{depth}_{res}px_s2d", trunk(6, True, depth),
                 (6, res, res)),
                (f"trunk_r{depth}_{res}px_rgb", trunk(3, False, depth),
                 (3, res, res)),
                (f"trunk_r{depth}_{res}px_rgb_s2d", trunk(3, True, depth),
                 (3, res, res))]
    out.append((f"dense_head_{2 * head_res}px",
                DenseHead(head_in, mask_dim=1, coord_dim=3, region_dim=33,
                          num_filters=num_filters, num_layers=3, norm="BN"),
                (head_in, head_res, head_res)))
    return out


def bench(name: str, module: nn.Module, shape: tuple[int, ...], args,
          device: torch.device, peak: float | None) -> list[dict]:
    from ..utils.profiling import count_flops

    torch.manual_seed(0)
    module = module.to(device)
    rng = np.random.RandomState(0)
    xs = [torch.from_numpy(rng.rand(args.batch, *shape).astype(np.float32))
          .to(device, torch.bfloat16) for _ in range(3)]

    def fwd(x):
        with torch.no_grad(), torch.autocast(device.type,
                                             dtype=torch.bfloat16):
            out = module(x)
        return out[0] if isinstance(out, (tuple, list)) else out

    lines = []
    for tag in ("eval", "train"):
        module.train(tag == "train")
        flops = count_flops(lambda: fwd(xs[0]))
        for i in range(args.warmup):
            float(fwd(xs[i % 3] + i * 1e-6).float().sum())
        t0 = time.perf_counter()
        for i in range(args.iters):
            float(fwd(xs[i % 3] + (i + 7) * 1e-6).float().sum())
        dt = (time.perf_counter() - t0) / args.iters
        line = {"module": name, "mode": tag, "batch": args.batch,
                "ms": dt * 1000,
                "mfu_pct": 100 * flops / dt / peak if flops and peak
                else None}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def run(args, **sizes) -> list[dict]:
    """Every module of ``modules(args.s2d, **sizes)`` in eval then train
    mode; print and return the JSON lines' dicts."""
    from ..utils.device import resolve_device
    from ..utils.profiling import bf16_peak_flops

    device = resolve_device(args.device)
    peak = bf16_peak_flops(device)
    lines = []
    for name, module, shape in modules(args.s2d, **sizes):
        lines += bench(name, module, shape, args, device, peak)
    return lines


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=192)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--s2d", action="store_true",
                   help="also bench the space-to-depth stem variants "
                        "(backbone.space_to_depth A/B)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
