#!/usr/bin/env python3
"""Time of the port's ``int8_conv`` kernel (``rdpn6d_tpu_torch``,
``csrc/int8_conv.cu``) at the shapes of int8 serving, on one NVIDIA GPU,
bfloat16 out:

    head 320->256 3x3     lm13's first head conv at B = 16, 64x64
    head 256->256 3x3     the head's other convs
    stage3 128->256 3x3/2 a trunk conv (int8-all), 32x32 -> 16x16

    python3 time_int8.py [--root DIR] [--plans]

``--root`` names the directory whose ``rdpn6d_tpu_torch`` is timed
(default: the one beside this script), so that two trees, such as a change
and its parent unpacked with ``git archive``, are compared in one run on
one card: parent, change, change, parent. The inputs are seeded int8
activations and weights, the same whatever the tree; the kernel's output
must equal its plain version's bit for bit. Each shape is timed three
ways: CUDA events around a burst of calls (three bursts), the device's
time a call queued behind filler work (``chip_smoke.queued_ms``) and, as a
third column only, the profiler's device time (which reads this kernel
low). Beside them: the bound (``chip_smoke.int8_conv_bound``), cuDNN's
bfloat16 ``F.conv2d`` of the same shape, ``torch._int_mm`` on an im2col
written beforehand (cuBLASLt's int8 GEMM; a yardstick only, the port never
calls it) and the plain version. ``--plans`` also times every tile width
the tree implements, forced, by CUDA events. Beside the device times, the
host's time to enqueue a call (few enough calls that the launch queue
never fills). Prints the card's name and
power limit beside each line, the conv kernel's registers and spills from
the tree's build log, then one JSON line. Exits non-zero without a CUDA
device or if a kernel disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ("head 320->256 3x3", "head 256->256 3x3", "stage3 128->256 3x3/2")
REPEATS = 3                  # bursts a shape
ITERS = 50                   # calls a burst
HOST_CALLS = 100             # calls timed on the host's clock


def conv_inputs(shape, dev):
    """Seeded int8 xq [B,H,W,Cp] and wq [N,k,k,Cp] (channels past C zero),
    scales sx [B] and sw [N], on ``dev``."""
    import torch

    _, B, H, W, C, N, k, _, _ = shape
    cp = -(-C // 32) * 32
    g = torch.Generator().manual_seed(C * N + H)
    xq = torch.zeros(B, H, W, cp, dtype=torch.int8)
    xq[..., :C] = torch.randint(-127, 128, (B, H, W, C), generator=g,
                                dtype=torch.int8)
    wq = torch.zeros(N, k, k, cp, dtype=torch.int8)
    wq[..., :C] = torch.randint(-127, 128, (N, k, k, C), generator=g,
                                dtype=torch.int8)
    sx = torch.rand(B, generator=g) * 0.02 + 1e-3
    sw = torch.rand(N, generator=g) * 0.002 + 1e-4
    return (v.to(dev) for v in (xq, sx, wq, sw))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="directory holding the rdpn6d_tpu_torch to time")
    ap.add_argument("--plans", action="store_true",
                    help="also time every tile width the tree implements")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_int8: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "rdpn6d_tpu_torch")):
        print(f"time_int8: no rdpn6d_tpu_torch/ under {root}",
              file=sys.stderr)
        return 2
    import chip_smoke as cs    # this script's own: timers, shapes, bound

    sys.path.insert(0, root)
    import rdpn6d_tpu_torch
    from rdpn6d_tpu_torch.ops import cuda_build
    from rdpn6d_tpu_torch.ops import int8_conv as ic

    pkg = os.path.dirname(os.path.abspath(rdpn6d_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        print(f"time_int8: imported {pkg}, not the one under {root}",
              file=sys.stderr)
        return 2
    card = cs.nvidia_smi("name,power.limit")
    dev = torch.device("cuda")
    tree = os.path.relpath(root, HERE)
    _, built = cuda_build.load(ic.LIBRARY)
    usage = getattr(cuda_build, "ptxas_usage", None)     # absent: older tree
    print(f"time_int8: {tree} built {os.path.relpath(built.path, HERE)}: "
          + ("; ".join(f"{u['registers']} registers, {u['spill_stores']} "
                       f"bytes spilled" for n, u in usage(built.log).items()
                       if "conv_kernel" in n) if usage else "")
          + f" [{card}]")
    shapes = {s[0]: s for s in cs.INT8_SHAPES}
    result = {"root": tree, "card": card, "shapes": []}
    for label in SHAPES:
        shape = shapes[label]
        _, B, H, W, C, N, k, stride, pad = shape
        xq, sx, wq, sw = conv_inputs(shape, dev)

        def run(plan=None):
            if plan is None:
                return ic.int8_conv(xq, sx, wq, sw, stride, pad,
                                    torch.bfloat16)
            return ic._int8_conv_launch(xq, sx, wq, sw, stride, pad,
                                        torch.bfloat16, plan)

        ref = ic.int8_conv_plain(xq, sx, wq, sw, stride, pad, torch.bfloat16)
        if not torch.equal(run(), ref):
            print(f"time_int8: {tree} {label}: the kernel disagrees with "
                  "its plain version", file=sys.stderr)
            return 1
        ms = [cs.cuda_ms(run, iters=ITERS) for _ in range(REPEATS)]
        q_ms = cs.queued_ms(run, iters=30)
        p_ms = cs.device_ms(run, iters=20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            run()
        host_us = 1e6 * (time.perf_counter() - t0) / HOST_CALLS
        torch.cuda.synchronize()
        plain_ms = cs.cuda_ms(lambda: ic.int8_conv_plain(
            xq, sx, wq, sw, stride, pad, torch.bfloat16), iters=3, warmup=1)
        xb = xq[..., :C].permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
        wb = wq[..., :C].permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
        lib_ms = cs.cuda_ms(lambda: F.conv2d(xb, wb, None, stride, pad),
                            iters=ITERS)
        cols = F.unfold(xb, k, padding=pad, stride=stride).transpose(
            1, 2).reshape(-1, k * k * C).to(torch.int8)
        wmat = wq[..., :C].permute(0, 3, 1, 2).reshape(N, -1).contiguous()
        mm_ms = cs.cuda_ms(lambda: torch._int_mm(cols, wmat.t()),
                           iters=ITERS)
        bound_ms, by = cs.int8_conv_bound(B, H, W, C, N, k, stride, pad)
        entry = {"shape": label, "B": B, "ms": ms, "queued_ms": q_ms,
                 "profiler_ms": p_ms, "host_us": host_us,
                 "bound_ms": bound_ms, "bound_by": by,
                 "cudnn_bf16_ms": lib_ms, "int_mm_ms": mm_ms,
                 "plain_ms": plain_ms}
        plan = getattr(ic, "int8_conv_plan", None)
        if plan is not None:
            Ho = ic.conv_out_size(H, k, stride, pad)
            Wo = ic.conv_out_size(W, k, stride, pad)
            K = k * k * xq.shape[3]
            p = plan(B, Ho, Wo, N, K, cuda_build.sm_count(dev.index))
            entry["plan"] = f"{p.bn} wide, {p.stages} stages"
        print(f"time_int8: {tree} {label} B={B} {H}x{W} bf16 out"
              + (f" ({entry['plan']})" if "plan" in entry else "")
              + ": CUDA events " + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms, queued {q_ms:.4f}, profiler {p_ms:.4f}, host "
              f"{host_us:.1f} us a call to enqueue; bound "
              f"{bound_ms:.4f} ms ({by}), {100 * bound_ms / min(ms):.1f}% "
              f"of it (events, best); cuDNN bf16 F.conv2d {lib_ms:.4f}; "
              f"torch._int_mm on a written im2col {mm_ms:.4f}; plain "
              f"{plain_ms:.4f} [{card}]")
        if args.plans and plan is not None:
            entry["plans"] = {}
            for bn in sorted(ic.STAGES):
                p = plan(B, Ho, Wo, N, K, bn=bn)
                if not torch.equal(run(p), ref):
                    print(f"time_int8: {tree} {label} {bn} wide: disagrees "
                          "with the plain version", file=sys.stderr)
                    return 1
                t = [cs.cuda_ms(lambda: run(p), iters=ITERS)
                     for _ in range(REPEATS)]
                entry["plans"][f"{bn}x{p.stages}"] = t
                print(f"time_int8: {tree} {label} plan {bn} wide, "
                      f"{p.stages} stages: CUDA events "
                      + ", ".join(f"{x:.4f}" for x in t) + f" ms [{card}]")
        result["shapes"].append(entry)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
