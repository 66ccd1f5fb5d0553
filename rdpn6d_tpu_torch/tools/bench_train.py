"""Train-step throughput at the flagship's width, and its decomposition.

Counterpart of ``tools/bench_train.py``: the wall time of forward,
backward and optimizer (``parallel.make_train_step``: bf16 autocast over
float32 parameters, the configured optimizer) a step at each of
``--batch-sizes``, on seeded weights and ``data.synthetic.
dummy_train_batch`` batches; distinct inputs every iteration, the loss
read back every iteration, warm-up excluded. ``--remat`` sets
``solver.remat``; ``--profile DIR`` traces 3 steps with
``utils.profiling.trace``; ``--decompose`` also times the eval-mode and
train-mode model forward, the forward with the losses, forward and
backward, and the optimizer step alone; ``--grouped-ab`` times raw
grouped frames through ``preprocess_rois_grouped`` then the step (two
calls) against ``make_fused_train_step`` (one), on the same frames and
the same draws (batch sizes are ROI counts, 5 ROIs a 480x640 frame). In
eager PyTorch the two paths launch the same kernels: the A/B alternates
their order step by step (AB, BA, ...), times each step, and adds the
fastest and the slowest step (``ms_min``, ``ms_max``) to the JAX tool's
keys, so that a gap between the means is read against the spread.

``tflops`` and ``mfu_pct`` count one step's model FLOPs with
``torch.utils.flop_counter`` (convolutions and matrix products, forward
and backward; under ``--remat`` counted on the step without it, so the
recompute is not counted as model work) over the card's dense bf16 peak
(``utils.profiling.bf16_peak_flops``: null on the CPU or an unknown
card). XLA's cost analysis, which the JAX tool reads, counts elementwise
work too: the two MFUs do not compare.

Usage: python -m rdpn6d_tpu_torch.tools.bench_train [--batch-sizes 24 96
    192] [--iters 12] [--remat] [--optimizer ranger] [--decompose]
    [--grouped-ab] [--profile DIR] [--opts ...] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def config(args):
    from ..config import Config

    opts = [f'solver.optimizer="{args.optimizer}"', *args.opts]
    if args.remat:
        opts.append("solver.remat=true")
    return Config().apply_opts(opts)


def setup(cfg, bs: int, device: torch.device):
    """(state, step, batch(i)) at ``bs`` ROIs: a seeded model and its
    optimizer on ``device``, ``make_train_step``, and the i-th batch of
    the timing (``dummy_train_batch`` with one of 4 images, perturbed by
    i)."""
    from ..data.synthetic import dummy_train_batch
    from ..models import RDPN, init_weights
    from ..parallel import create_train_state, make_train_step
    from ..solver import build_schedule

    host = dummy_train_batch(cfg, batch_size=bs)
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    rng = np.random.RandomState(0)
    imgs = [torch.from_numpy(rng.rand(*host["roi_img"].shape)
                             .astype(np.float32)).to(device)
            for _ in range(4)]
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(0)) \
        .to(device)
    schedule = build_schedule(cfg, 1000)
    state = create_train_state(cfg, model, lr=schedule(0))

    def batch_at(i: int) -> dict:
        b = dict(batch)
        b["roi_img"] = imgs[i % len(imgs)] + (i * 1e-6)
        return b

    return state, make_train_step(cfg, schedule), batch_at


def _mfu(flops: float, dt: float, peak: float | None):
    return 100 * flops / dt / peak if flops and peak else None


def model_flops(state, fn) -> float:
    """The FLOPs of ``fn()`` (a step on ``state``) with ``solver.remat``
    off for its duration: the model's work, without the recompute."""
    from ..utils.profiling import count_flops

    model = state.model
    cfg = model.cfg
    model.cfg = cfg.apply_opts(["solver.remat=false"])
    try:
        return count_flops(fn)
    finally:
        model.cfg = cfg


def bench_batch(cfg, bs: int, args, device: torch.device,
                peak: float | None) -> list[dict]:
    from ..utils.profiling import trace

    state, step_fn, batch_at = setup(cfg, bs, device)

    def run(i):
        nonlocal state
        state, metrics = step_fn(state, batch_at(i))
        return metrics

    # one step counted, before the warm-up
    flops = model_flops(state, lambda: run(0))
    for i in range(args.warmup):
        float(run(i)["total_loss"])            # value readback
    if args.profile:
        with trace(args.profile):
            for i in range(3):
                float(run(i)["total_loss"])
        print(f"trace written to {args.profile}", flush=True)
    t0 = time.perf_counter()
    for i in range(args.iters):
        float(run(i + 7)["total_loss"])
    dt = (time.perf_counter() - t0) / args.iters
    lines = [{
        "metric": "train poses/sec/chip (fwd+bwd+%s%s)"
                  % (args.optimizer, "+remat" if args.remat else ""),
        "batch": bs,
        "ms_per_step": dt * 1000,
        "value": bs / dt,
        "unit": "poses/sec",
        "tflops": flops / dt / 1e12 if flops else None,
        "mfu_pct": _mfu(flops, dt, peak),
    }]
    print(json.dumps(lines[0]), flush=True)
    if args.decompose:
        lines += decompose(cfg, bs, args, device, state, batch_at)
    return lines


def decompose(cfg, bs: int, args, device: torch.device, state,
              batch_at) -> list[dict]:
    """The five parts of the step, each timed as the step is."""
    from ..losses import compute_losses
    from ..parallel.train_step import _dropblock_kwargs

    model, opt = state.model, state.optimizer
    amp = torch.autocast(device.type, dtype=torch.bfloat16,
                         enabled=cfg.solver.amp)
    lines = []

    def time_fn(fn, tag):
        for i in range(args.warmup):
            float(fn(i))
        t0 = time.perf_counter()
        for i in range(args.iters):
            float(fn(i + 7))
        line = {"metric": f"decompose/{tag}", "batch": bs,
                "ms": (time.perf_counter() - t0) / args.iters * 1000}
        print(json.dumps(line), flush=True)
        lines.append(line)

    def forward(b, train: bool):
        model.train(train)
        kwargs = _dropblock_kwargs(cfg, state.step, device) if train \
            else {}
        with amp:
            return model(b, **kwargs)

    def loss(i):
        b = batch_at(i)
        return sum(compute_losses(cfg, forward(b, True), b).values())

    def model_only(i, train):
        with torch.no_grad():
            return forward(batch_at(i), train)["rot_ego"].sum()

    def fwd_bwd(i):
        opt.zero_grad(set_to_none=True)
        total = loss(i)
        total.backward()
        return total.detach()

    def opt_step(i):
        opt.step()
        return next(model.parameters()).detach().sum()

    time_fn(lambda i: model_only(i, False), "model_fwd_eval")
    time_fn(lambda i: model_only(i, True), "model_fwd_train")
    with torch.no_grad():
        time_fn(loss, "fwd_only")
    time_fn(fwd_bwd, "fwd_bwd")
    fwd_bwd(0)
    time_fn(opt_step, "optimizer_only")
    return lines


def grouped_ab(cfg, args, device: torch.device,
               peak: float | None) -> list[dict]:
    """The two-call grouped path against the fused step: the same raw
    (frames, rois), the same seeded draws each iteration. The two-call
    time includes the preprocessing the plain bench leaves out. The two
    paths' steps alternate, in the order AB, BA, AB, ..., each timed to
    its loss readback."""
    from ..data.pipeline import preprocess_rois_grouped
    from ..data.synthetic import dummy_grouped_inputs
    from ..models import RDPN, init_weights
    from ..parallel import (create_train_state, make_fused_train_step,
                            make_train_step)
    from ..solver import build_schedule

    rpf = 5
    tags = ("two_program", "fused")
    schedule = build_schedule(cfg, 1000)
    generator = torch.Generator(device=device)
    lines = []
    for bs in args.batch_sizes:
        n_frames = max(bs // rpf, 1)
        frames, rois = dummy_grouped_inputs(cfg, n_frames=n_frames,
                                            rois_per_frame=rpf,
                                            im_hw=(480, 640))
        frames = {k: torch.from_numpy(v).to(device)
                  for k, v in frames.items()}
        rois = {k: torch.from_numpy(v).to(device) for k, v in rois.items()}
        n_rois = int(rois["frame_idx"].shape[0])
        weights = init_weights(RDPN(cfg), torch.Generator().manual_seed(0)) \
            .state_dict()
        two_call = make_train_step(cfg, schedule)
        fused = make_fused_train_step(cfg, schedule)
        states = {}
        for tag in tags:
            model = RDPN(cfg)
            model.load_state_dict(weights)
            states[tag] = create_train_state(cfg, model.to(device),
                                             lr=schedule(0))

        def run(tag, i):
            generator.manual_seed(3 + i)
            if tag == "fused":
                states[tag], metrics = fused(states[tag], frames, rois,
                                             generator)
            else:
                batch = preprocess_rois_grouped(
                    cfg, frames, rois, train=True, generator=generator)
                states[tag], metrics = two_call(states[tag], batch)
            return metrics

        # one step counted on each path, before the warm-up
        flops = {tag: model_flops(states[tag], lambda: run(tag, 0))
                 for tag in tags}
        for i in range(args.warmup):
            for tag in tags:
                float(run(tag, i)["total_loss"])
        times = {tag: [] for tag in tags}
        for i in range(args.iters):
            for tag in (tags if i % 2 == 0 else tags[::-1]):
                t0 = time.perf_counter()
                float(run(tag, i + 7)["total_loss"])
                times[tag].append(time.perf_counter() - t0)
        for tag in tags:
            dt = float(np.mean(times[tag]))
            line = {
                "metric": f"grouped_ab/{tag} (raw frames -> fwd+bwd+opt)",
                "rois": n_rois, "frames": n_frames,
                "ms_per_step": dt * 1000,
                "poses_per_sec": n_rois / dt,
                "mfu_pct": _mfu(flops[tag], dt, peak),
                "ms_min": min(times[tag]) * 1000,
                "ms_max": max(times[tag]) * 1000,
            }
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


def run(args) -> list[dict]:
    """Every batch size (or the grouped A/B); print and return the JSON
    lines' dicts."""
    from ..utils.device import resolve_device
    from ..utils.profiling import bf16_peak_flops

    device = resolve_device(args.device)
    cfg = config(args)
    peak = bf16_peak_flops(device)
    if args.grouped_ab:
        return grouped_ab(cfg, args, device, peak)
    lines = []
    for bs in args.batch_sizes:
        lines += bench_batch(cfg, bs, args, device, peak)
    return lines


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch-sizes", type=int, nargs="*",
                   default=[24, 96, 192])
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--optimizer", default="ranger")
    p.add_argument("--profile", default="",
                   help="capture a device trace of 3 steps into this dir")
    p.add_argument("--decompose", action="store_true",
                   help="additionally time fwd-only, fwd+bwd (no opt), "
                        "and optimizer-only — the step-time breakdown")
    p.add_argument("--opts", nargs="*", default=[])
    p.add_argument("--grouped-ab", action="store_true",
                   help="A/B the grouped input path at flagship frame "
                        "size: preprocessing then the step (two calls) "
                        "vs the fused step, on identical raw inputs "
                        "(batch-sizes = ROI counts; rois_per_frame=5)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
