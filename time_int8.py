#!/usr/bin/env python3
"""Time of the port's int8 kernels (``rdpn6d_tpu_torch``,
``csrc/int8_conv.cu``) at the shapes of int8 serving, on one NVIDIA GPU,
bfloat16:

    head 320->256 3x3     lm13's first head conv at B = 16, 64x64
    head 256->256 3x3     the head's other convs
    stage3 128->256 3x3/2 a trunk conv (int8-all), 32x32 -> 16x16

then the quantizers at the head's shapes (256 BN'd channels, and 256 +
rot_concat's 64 skip channels, B = 16, 64x64): the fused
``bn_relu_quantize`` where the tree has it ("absent" where not), and the
unfused sequence it replaces (torch's BN, ReLU, ``torch.cat``, then the
tree's ``quantize_act``), static and dynamic, by CUDA events over bursts
and by ``queued_ms`` (a burst of one quantizer call is bound by the host's
time to make the call, so the queued time is the device's); and last the
whole lm13
int8-head-static head (``DenseHead``, seeded weights, static scales
calibrated on its input) at B = 16: its device time a batch and its
kernel launches a call; and the whole bf16 lm13 model's forward at
B = 16 the same way (what the bf16 serving path pays for its norms).

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
    result["quantizers"] = time_quantizers(cs, ic, dev, tree, card)
    result["head"] = time_head(cs, dev, tree, card)
    result["bf16_model"] = time_bf16_model(cs, dev, tree, card)
    print(json.dumps(result))
    return 0


def quantizer_inputs(dev, B, C1, C2, H, W, mode):
    """Seeded bf16 y [B,C1,H,W] and skip [B,C2,H,W] on ``dev``, an eval
    ``nn.BatchNorm2d`` with float32 statistics, its folded (mean, mul,
    bias) and the static amax (None in the dynamic mode), made with
    PyTorch alone: the same whatever the tree."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(C1 + C2)
    y = (torch.randn(B, C1, H, W, generator=g)
         * (torch.rand(C1, generator=g) * 3)[None, :, None, None]).to(
        dev, torch.bfloat16)
    skip = torch.randn(B, C2, H, W, generator=g).clamp_min(0).to(
        dev, torch.bfloat16) if C2 else None
    bn = torch.nn.BatchNorm2d(C1, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.randn(C1, generator=g))
        bn.bias.copy_(torch.randn(C1, generator=g) * 0.5)
        bn.running_mean.copy_(torch.randn(C1, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(C1, generator=g) * 2 + 0.05)
    rs = (1.0 / np.sqrt((bn.running_var + bn.eps).double().numpy())).astype(
        np.float32)
    consts = (bn.running_mean, torch.from_numpy(rs) * bn.weight.detach(),
              bn.bias.detach())
    bn = bn.eval().to(dev)
    consts = tuple(v.to(dev) for v in consts)
    amax = None
    if mode == "static":
        a = F.relu(bn(y)).float()
        amax = a.abs().amax() * 0.9
        if skip is not None:
            amax = torch.maximum(amax, skip.float().abs().amax())
    return y, skip, bn, consts, amax, None


def time_quantizers(cs, ic, dev, tree, card) -> list:
    """The fused quantizer (where the tree has it) against the unfused
    sequence of the same tree at the head's shapes, bf16, static and
    dynamic, by CUDA events (three bursts) and ``queued_ms``."""
    import torch
    import torch.nn.functional as F

    fused_op = getattr(ic, "bn_relu_quantize", None)
    out = []
    for label, B, C1, C2, H, W in cs.FUSED_HEAD:
        bound, by = cs.bn_relu_quantize_bound(B, C1, C2, H, W)
        for mode in ("static", "dynamic"):
            y, skip, bn, consts, amax, t = quantizer_inputs(
                dev, B, C1, C2, H, W, mode)

            def unfused():
                a = F.relu(bn(y))
                if skip is not None:
                    a = torch.cat([a, skip], dim=1)
                return ic.quantize_act(a, mode, amax, t)

            def fused():
                return fused_op(y, *consts, mode, amax, t, skip)

            a = F.relu(bn(y))
            if skip is not None:
                a = torch.cat([a, skip], dim=1)
            entry = {"shape": label, "mode": mode, "bound_ms": bound,
                     "unfused_ms": [cs.cuda_ms(unfused, iters=ITERS)
                                    for _ in range(REPEATS)],
                     "unfused_queued_ms": cs.queued_ms(unfused, iters=30),
                     "quantize_act_ms": [cs.cuda_ms(
                         lambda: ic.quantize_act(a, mode, amax, t),
                         iters=ITERS) for _ in range(REPEATS)],
                     "quantize_act_queued_ms": cs.queued_ms(
                         lambda: ic.quantize_act(a, mode, amax, t),
                         iters=30),
                     "quantize_act_bound_ms": cs.quantize_act_bound(
                         B, C1 + C2, H, W)[0]}
            if fused_op is not None:
                xq, sx = fused()
                rq, rs = ic.bn_relu_quantize_plain(y, *consts, mode, amax,
                                                   t, skip)
                if not (torch.equal(xq, rq) and torch.equal(sx, rs)):
                    raise SystemExit(f"time_int8: {tree} bn_relu_quantize "
                                     f"{label} {mode}: disagrees with its "
                                     "plain version")
                entry["fused_ms"] = [cs.cuda_ms(fused, iters=ITERS)
                                     for _ in range(REPEATS)]
                entry["fused_queued_ms"] = cs.queued_ms(fused, iters=30)
            fz = ("absent" if fused_op is None else
                  ", ".join(f"{v:.4f}" for v in entry["fused_ms"])
                  + f" ms, queued {entry['fused_queued_ms']:.4f}, "
                  f"{100 * bound / entry['fused_queued_ms']:.1f}% of bound "
                  "(queued)")
            print(f"time_int8: {tree} quantizers {label} B={B} {H}x{W} "
                  f"bf16 {mode}: bn_relu_quantize {fz}; bound {bound:.4f} "
                  f"ms ({by}); unfused BN + ReLU"
                  f"{' + cat' if skip is not None else ''} + quantize_act "
                  + ", ".join(f"{v:.4f}" for v in entry["unfused_ms"])
                  + f" ms, queued {entry['unfused_queued_ms']:.4f}; "
                  "quantize_act alone "
                  + ", ".join(f"{v:.4f}" for v in entry["quantize_act_ms"])
                  + f" ms, queued {entry['quantize_act_queued_ms']:.4f} "
                  f"(bound {entry['quantize_act_bound_ms']:.4f}) [{card}]")
            out.append(entry)
    return out


def time_head(cs, dev, tree, card) -> dict:
    """lm13's int8-head-static head at B = 16, seeded weights (the port's
    init, then BN statistics drawn from a seed), its static scales
    calibrated on the seeded input: device ms a call (``queued_ms`` behind
    a 4096² float32 product; the profiler's sum) and kernel launches a
    call (profiler)."""
    import torch

    from rdpn6d_tpu_torch.configs import lm13
    from rdpn6d_tpu_torch.models import RDPN, init_weights
    from rdpn6d_tpu_torch.models.quant import calibrate_quant

    cfg = lm13.get_config().apply_opts(['head.init="fan_in"'])
    model = init_weights(RDPN(cfg, int8="head", int8_static=True),
                         torch.Generator().manual_seed(0))
    head = model.rot_head_net
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in head.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.copy_(torch.rand(m.num_features, generator=g)
                                    + 0.5)
                m.running_mean.copy_(torch.randn(m.num_features,
                                                 generator=g) * 0.1)
    head = head.to(dev, torch.bfloat16).eval()
    f = head.features
    skip_c = f[3].in_channels - f[0].out_channels
    x = torch.randn(16, f[0].in_channels, 32, 32, generator=g).to(
        dev, torch.bfloat16)
    skip = torch.randn(16, skip_c, 64, 64, generator=g).clamp_min(0).to(
        dev, torch.bfloat16)

    class Bound(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.head = head

        def forward(self, inp):
            return self.head(inp, skip)

    calibrate_quant(Bound().eval(), [x])   # leaves the head in eval mode

    def run():
        with torch.no_grad():
            return head(x, skip)

    q = cs.queued_ms(run, iters=20, filler=4096)
    p_ms, n = cs.profiled_calls(run, iters=10)
    print(f"time_int8: {tree} lm13 int8-head-static head at B = 16: device "
          f"time {q:.4f} ms a batch (queued; profiler {p_ms:.4f}), "
          f"{n:.0f} kernel launches a call [{card}]")
    return {"queued_ms": q, "profiler_ms": p_ms, "launches": n}



def time_bf16_model(cs, dev, tree, card) -> dict:
    """The whole lm13 model in bf16 (seeded weights, eval mode) on a
    seeded batch of 16 ROIs: device ms a forward (``queued_ms`` behind an
    8192² float32 product, longer than the host takes to launch it; the
    profiler's sum) and kernel launches a forward (profiler)."""
    import torch

    from rdpn6d_tpu_torch.configs import lm13
    from rdpn6d_tpu_torch.data.synthetic import dummy_train_batch
    from rdpn6d_tpu_torch.models import RDPN, init_weights

    cfg = lm13.get_config().apply_opts(['head.init="fan_in"'])
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(0))
    model = model.to(dev, torch.bfloat16).eval()
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in dummy_train_batch(cfg, 16, seed=2).items()}

    def run():
        with torch.no_grad():
            return model(batch)

    q = cs.queued_ms(run, iters=10, filler=8192)
    p_ms, n = cs.profiled_calls(run, iters=5)
    print(f"time_int8: {tree} lm13 bf16 model forward at B = 16: device "
          f"time {q:.4f} ms (queued; profiler {p_ms:.4f}), {n:.0f} kernel "
          f"launches a forward [{card}]")
    return {"queued_ms": q, "profiler_ms": p_ms, "launches": n}


if __name__ == "__main__":
    sys.exit(main())
