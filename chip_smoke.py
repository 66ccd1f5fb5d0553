#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rdpn6d_tpu_torch``) on one NVIDIA
GPU: the quickest proof that the port builds and serves on the card.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure:
  1. build  — every CUDA kernel of the path, from ``rdpn6d_tpu_torch/csrc``
              with nvcc for sm_90a (in parallel, one nvcc per source);
  2. kernel — each kernel against its plain PyTorch version on the card, at
              ragged shapes and at the scoring shape, with kernel, plain,
              library-call and bound times;
  3. serve  — the lm13 configuration at full width (ResNet-34, 256² ROIs,
              64² head maps, 32 regions, rot_concat), seeded random
              weights, through ``Predictor.predict``: 3 distinct 480x640
              RGB-D frames with 5, 6 and 5 detections, in bf16 and float32;
  4. score  — ADD / ADI / re / te / proj of those poses against seeded GT
              poses on a 13-object bank of 4096 model points each; ADI
              goes through the ``min_dist2`` kernel (its launch count must
              rise) and must match the same scoring on the CPU;
  5. parity — the float32 served path on the card (no TF32) against the
              same weights and frames on the CPU.
Kernel launch counts are zeroed right before phase 3 and read right after
phase 4. Output: the card's name and power limit (nvidia-smi), one
``{"kernels": [...]}`` JSON line, then ``{"ok": true, "device": {...}}`` as
the last line. Exits non-zero, printing no result, without a CUDA device
or without the ``rdpn6d_tpu_torch`` package beside this file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s HBM3; 67 TFLOP/s FP32
# outside the tensor cores, which counts each lane's FMA as 2 operations:
# 132 SMs x 128 lanes x 1.98 GHz issue 33.5e12 FP32 instructions a second
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
# min_dist2's work per (a, b) pair: 3 subtractions, 3 multiply(-add)s and a
# min, 7 FP32 instructions
MIN_DIST2_INSTR_PER_PAIR = 7


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``iters``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def lm_assets(num_regions: int, n_points: int, seed: int):
    """13 box-shaped objects with LineMOD-like extents: n_points sampled
    uniformly on each surface, FPS keypoints, no symmetries."""
    from rdpn6d_tpu_torch.data.assets import (
        ClassAssets,
        fps_numpy,
        pad_sym_trans,
        pad_symmetries,
    )

    rng = np.random.RandomState(seed)
    ext = rng.uniform(0.06, 0.2, (13, 3)).astype(np.float32)
    pts = []
    for e in ext:
        p = rng.uniform(-0.5, 0.5, (n_points, 3))
        face = rng.randint(0, 3, n_points)
        p[np.arange(n_points), face] = np.sign(
            p[np.arange(n_points), face]) * 0.5   # onto a face
        pts.append((p * e).astype(np.float32))
    pts = np.stack(pts)
    fps = np.stack([p[fps_numpy(p, num_regions)] for p in pts])
    return ClassAssets(
        obj_ids=list(range(1, 14)), points=pts, extents=ext,
        fps_points=fps, sym_rots=pad_symmetries([None] * 13),
        sym_trans=pad_sym_trans([None] * 13),
        diameters=np.linalg.norm(ext, axis=1).astype(np.float32))


def make_frames(seed: int, counts=(5, 6, 5)):
    """Distinct 480x640 RGB-D frames (smooth colour field + noise, depth
    0.6-1.2 m) with seeded detection boxes."""
    from rdpn6d_tpu_torch.engine.predictor import Detection

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    frames = []
    for f, n in enumerate(counts):
        phase = rng.uniform(0, 6.28, 3)
        rgb = np.stack([127 + 100 * np.sin(xx / (40 + 9 * c) + yy / 55
                                           + phase[c]) for c in range(3)],
                       -1) + rng.normal(0, 8, (480, 640, 3))
        depth = 0.9 + 0.3 * np.sin(xx / 120 + phase[0]) * np.cos(yy / 90)
        dets = []
        for _ in range(n):
            w, h = rng.uniform(50, 180, 2)
            x1, y1 = rng.uniform(0, 640 - w), rng.uniform(0, 480 - h)
            dets.append(Detection(int(rng.randint(1, 14)),
                                  np.array([x1, y1, x1 + w, y1 + h],
                                           np.float32),
                                  float(rng.uniform(0.5, 1.0))))
        frames.append((np.clip(rgb, 0, 255).astype(np.uint8),
                       depth.astype(np.float32), dets))
    return frames


K_LM = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
                 [0.0, 0.0, 1.0]], np.float32)


def physical_z(pred):
    """Random weights put objects millimetres from the camera; a z bias
    moves them to ~0.5-1 m, where poses project and score sensibly."""
    import torch

    with torch.no_grad():
        pred.model.pnp_net.fc_t.bias[2] = 2.0
    return pred


def profile_serve(pred, frames) -> None:
    """Device time by kernel over one served pass (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, secs = serve(pred, frames)
    # kernels only: an aten op's own row repeats its kernels' device time
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e3   # ms
    print(f"profile: wall {secs * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (secs * 1e3):.1f}%), {len(events)} kernel names")
    for e in events[:15]:
        print(f"profile: {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")


def serve(pred, frames):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [pred.predict(rgb, depth, K_LM, dets)
            for rgb, depth, dets in frames]
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one served pass with torch.profiler "
                         "and print the device time by kernel")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "rdpn6d_tpu_torch")):
        print("chip_smoke: rdpn6d_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    from rdpn6d_tpu_torch.configs import lm13
    from rdpn6d_tpu_torch.engine.predictor import Predictor
    from rdpn6d_tpu_torch.evaluation import pose_error as pe
    from rdpn6d_tpu_torch.ops import cuda_build
    from rdpn6d_tpu_torch.ops.min_dist import min_dist2, min_dist2_plain

    card = nvidia_smi("name,power.limit")
    print(f"card: {card}; max SM clock {nvidia_smi('clocks.max.sm')}")
    dev = torch.device("cuda")

    # 1. build --------------------------------------------------------------
    kernels = ["min_dist2"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; from rdpn6d_tpu_torch.ops "
         f"import cuda_build; cuda_build.build({k!r})"], cwd=ROOT)
        for k in kernels]
    for k, p in zip(kernels, procs):
        check(p.wait(timeout=900) == 0, f"build of {k} failed")
    for k in kernels:
        _, built = cuda_build.load(k)
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build: {k} -> {os.path.relpath(built.path, ROOT)}; "
              + " | ".join(ptxas))
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(kernels)} "
          "kernel(s)")

    # 2. kernel vs plain ------------------------------------------------------
    gen = torch.Generator(device="cpu").manual_seed(0)
    errs = {}
    for (B, n, m, d) in [(1, 7, 5, 3), (1, 300, 700, 3), (2, 100, 129, 5),
                         (16, 4096, 4096, 3)]:
        a = (torch.randn(B, n, d, generator=gen) * 0.05
             + torch.tensor([0.0, 0.0, 1.0] + [0.0] * (d - 3))).to(dev)
        b = (torch.randn(B, m, d, generator=gen) * 0.05
             + torch.tensor([0.0, 0.0, 1.0] + [0.0] * (d - 3))).to(dev)
        out = min_dist2(a, b)
        ref = min_dist2_plain(a, b)
        torch.cuda.synchronize()
        scale = float((a * a).sum(-1).max() + (b * b).sum(-1).max())
        err = float((out - ref).abs().max())
        # both run the direct form in float32; they differ only by FMA
        # contraction, a few ulps of the largest squared norm
        tol = 1e-6 * scale
        print(f"kernel: min_dist2 B={B} N={n} M={m} D={d} max_abs_err "
              f"{err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"min_dist2 disagrees with plain at {B}x{n}x{m}")
        errs[(B, n, m, d)] = err
    B, N, M = 16, 4096, 4096
    ms = cuda_ms(lambda: min_dist2(a, b), iters=50)
    plain_ms = cuda_ms(lambda: min_dist2_plain(a, b), iters=5, warmup=1)
    lib_ms = cuda_ms(lambda: torch.cdist(a, b).square().amin(-1), iters=10)
    ops_s = B * N * M * MIN_DIST2_INSTR_PER_PAIR / FP32_INSTR_PER_S
    bytes_s = (B * N * 3 + B * M * 3 + B * N) * 4 / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(ops_s, bytes_s)
    print(f"kernel: min_dist2 16x4096x4096 kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, cdist {lib_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({'operations' if ops_s >= bytes_s else 'bytes'}) [{card}]")

    # 3. serve ----------------------------------------------------------------
    cfg = lm13.get_config().apply_opts(['head.init="fan_in"'])
    assets = lm_assets(cfg.head.num_regions, 4096, seed=1)
    frames = make_frames(seed=2)
    n_det = sum(len(f[2]) for f in frames)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    preds = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        preds[name] = physical_z(Predictor(
            cfg, assets, batch_size=16, dtype=dt, device="cuda",
            allow_random_init=True))
        serve(preds[name], frames)    # warm-up: cuDNN plans per batch size
    cuda_build.reset_launches()
    served = {}
    for name in ("bf16", "f32"):
        outs, secs = serve(preds[name], frames)
        flat = [r for o in outs for r in o]
        check(len(flat) == n_det, f"{name}: {len(flat)} poses for "
              f"{n_det} detections")
        R = np.stack([r["R"] for r in flat])
        t = np.stack([r["t"] for r in flat])
        check(R.shape == (n_det, 3, 3) and t.shape == (n_det, 3),
              f"{name}: pose shapes {R.shape} {t.shape}")
        check(bool(np.isfinite(R).all() and np.isfinite(t).all()),
              f"{name}: non-finite poses")
        served[name] = (flat, R, t)
        print(f"serve: lm13 full width {name}: {n_det} poses from "
              f"{len(frames)} frames in {secs * 1e3:.1f} ms = "
              f"{n_det / secs:.1f} poses/s [{card}]")

    if args.profile:
        profile_serve(preds["bf16"], frames)

    # 4. score ----------------------------------------------------------------
    flat, R_est, t_est = served["f32"]
    rng = np.random.RandomState(3)
    q, _ = np.linalg.qr(rng.randn(n_det, 3, 3))
    R_gt = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    t_gt = np.concatenate([rng.uniform(-0.15, 0.15, (n_det, 2)),
                           rng.uniform(0.6, 1.2, (n_det, 1))], 1)
    pts = np.stack([assets.for_obj(r["obj_id"])["points"] for r in flat])
    host = [R_est, t_est.astype(np.float32), R_gt, t_gt.astype(np.float32),
            pts, np.broadcast_to(K_LM, (n_det, 3, 3)).copy()]
    on_card = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
               for x in host]
    scores = {
        "add": pe.add(*on_card[:5]), "adi": pe.adi(*on_card[:5]),
        "re": pe.re_deg(on_card[0], on_card[2]),
        "te": pe.te(on_card[1], on_card[3]), "proj": pe.proj_2d(*on_card)}
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    for k in kernels:
        check(launches.get(k, 0) > 0,
              f"{k} was not launched on the served + scored path")
    on_cpu = [torch.from_numpy(np.ascontiguousarray(x)) for x in host]
    adi_cpu = pe.adi(*on_cpu[:5])
    adi_err = float((scores["adi"].cpu() - adi_cpu).abs().max())
    # the card's kernel and the CPU's plain version differ by FMA rounding
    # of squared distances ~0.1 m^2: well under 1e-6 m after the sqrt
    check(adi_err <= 1e-6, f"adi card vs CPU differs by {adi_err:.3e} m")
    for k, v in scores.items():
        v = v.cpu().numpy()
        check(v.shape == (n_det,) and bool(np.isfinite(v).all()),
              f"score {k}: shape {v.shape} or non-finite")
        print(f"score: {k} mean {v.mean():.6f} over {n_det} poses")
    print(f"score: adi card vs CPU max diff {adi_err:.3e} m; launches "
          f"{launches}")

    # 5. card vs CPU ------------------------------------------------------------
    cpu_pred = physical_z(Predictor(
        cfg, assets, batch_size=16, dtype=torch.float32, device="cpu",
        allow_random_init=True))
    rgb, depth, dets = frames[0]
    cpu_out = cpu_pred.predict(rgb, depth, K_LM, dets)
    gpu_out = preds["f32"].predict(rgb, depth, K_LM, dets)
    dR = max(float(np.abs(a["R"] - b["R"]).max())
             for a, b in zip(gpu_out, cpu_out))
    dt_rel = max(float(np.abs(a["t"] - b["t"]).max()
                       / np.abs(b["t"]).max()) for a, b in zip(gpu_out,
                                                              cpu_out))
    print(f"parity: f32 card vs CPU over {len(dets)} ROIs: max |dR| "
          f"{dR:.3e}, max |dt|/|t| {dt_rel:.3e}")
    # float32 on both (TF32 off); cuDNN and oneDNN sum in other orders
    # through ~40 layers, and a region argmax near-tie may flip a pixel
    check(dR <= 1e-3 and dt_rel <= 1e-3, "card and CPU poses disagree")

    result = {"kernels": [{
        "name": "min_dist2", "route": "cuda",
        "source": "rdpn6d_tpu_torch/csrc/min_dist2.cu",
        "replaces": "rdpn6d_tpu/ops/pallas_kernels.py:57",
        "launches": launches.get("min_dist2", 0),
        "max_abs_err": max(errs.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": lib_ms}], "card": card}
    print(card)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
