"""The trunk's forward in three memory layouts of its input.

Counterpart of ``tools/bench_layout.py``, which times XLA's input relayout
ahead of the trunk's thin-channel stem and its AUTO input layout. The
torch analogue is the memory format. This tool times the bf16 forward of
the ResNet-34 trunk (eval mode, the model cast to bf16 as served) on the
RGB of 256² ROIs in three forms:

  a. as ``RDPN.forward`` feeds it: the [B, S, S, 6] channels-last batch
     permuted to NCHW and sliced to RGB, a channels-last-strided view,
     into the module in the default memory format;
  b. a contiguous NCHW input, the module as in (a);
  c. the module and the input in ``torch.channels_last``.

Each form's input is made once, outside the timing (as the JAX tool
stages its formatted arrays): a burst of ``--iters`` forwards over 3
distinct inputs, synchronized at the end, after ``--warmup`` synchronized
ones. Prints a JSON line a form with its ms a forward and the largest
difference of its output from (a)'s on the same input.

Usage: python -m rdpn6d_tpu_torch.tools.bench_layout [--batch 64]
    [--iters 20] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

FORMS = {
    "a": "as RDPN.forward feeds it (NHWC batch permuted, default-format "
         "module)",
    "b": "contiguous NCHW input",
    "c": "channels_last module and input",
}


def run(args, depth: int = 34, res: int = 256,
        dtype: torch.dtype = torch.bfloat16) -> list[dict]:
    """Time the three forms; print and return their JSON lines' dicts."""
    from ..models.resnet import ResNetTrunk
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    torch.manual_seed(0)
    module = ResNetTrunk(depth).to(device=device, dtype=dtype).eval()
    rng = np.random.RandomState(0)
    nhwc = [torch.from_numpy(rng.rand(args.batch, res, res, 6)
                             .astype(np.float32)).to(device, dtype)
            for _ in range(3)]
    inputs = {
        "a": [x.permute(0, 3, 1, 2)[:, :3] for x in nhwc],
        "b": [x.permute(0, 3, 1, 2)[:, :3].contiguous() for x in nhwc],
        "c": [x.permute(0, 3, 1, 2)[:, :3].contiguous(
            memory_format=torch.channels_last) for x in nhwc],
    }

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    lines, ref = [], None
    for form, xs in inputs.items():
        module = module.to(memory_format=torch.channels_last if form == "c"
                           else torch.contiguous_format)
        with torch.no_grad():
            out = module(xs[0]).float()
            for i in range(args.warmup):
                module(xs[i % len(xs)])
                sync()
            t0 = time.perf_counter()
            for i in range(args.iters):
                module(xs[i % len(xs)])
            sync()
        ms = (time.perf_counter() - t0) / args.iters * 1e3
        ref = out if ref is None else ref
        line = {"form": form, "layout": FORMS[form], "batch": args.batch,
                "ms_per_fwd": ms,
                "max_abs_diff_vs_a": float((out - ref).abs().max())}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
