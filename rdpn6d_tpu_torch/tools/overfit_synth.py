"""Synthetic overfit run: the whole Trainer stack learning a pose.

Counterpart of ``tools/overfit_synth.py``. Renders N views of a cube (or of
the mini dataset's asymmetric tetrahedron), preprocesses them once on the
device (``data/pipeline.preprocess_batch``, train mode: the ``roi_crop``
and ``gt_labels`` kernels), trains the flagship-shaped model on that one
batch through ``engine/trainer.Trainer`` (checkpoints and writers
included), then evaluates ADD/re/te on the training views in each serving
mode: full precision (bf16 autocast at full width), ``--kabsch`` (the
RANSAC-Kabsch refinement, ``test.use_pnp``), and with ``--int8`` the W8A8
modes, dynamic and calibrated (``models/quant.calibrate_quant``). Each
mode prints ``RESULT[tag] ad_10=... re_5=... te_2=... AUCad=...`` as the
JAX tool does; one more line gives ms/step and peak device memory.

Usage: python -m rdpn6d_tpu_torch.tools.overfit_synth [--steps 300] \\
    [--n-views 16] [--mesh cube|tetra] [--kabsch] [--int8 [--int8-stages]] \\
    [--small] [--device cuda]
"""

from __future__ import annotations

import argparse
import itertools
import logging
import os
import tempfile
import time

import numpy as np
import torch

K_OVERFIT = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                     np.float32)
H, W = 480, 640


def tetra_mesh() -> tuple[np.ndarray, np.ndarray]:
    """The mini dataset's irregular ASYMMETRIC tetrahedron ('ape', obj 1)
    in metres: its orientation is fully identifiable from geometry, unlike
    the cube's 24-fold-ambiguous faces."""
    from ..data.synthetic import mini_meshes

    v, f = mini_meshes()[1]
    return (v / 1000.0).astype(np.float32), f


def build_scenes(cfg, n_views: int, num_regions: int, seed: int = 0,
                 mesh: str = "cube", device: str | torch.device = "cpu",
                 generator: torch.Generator | None = None,
                 center_scale: tuple[torch.Tensor, torch.Tensor]
                 | None = None):
    """Render ``n_views`` random views, drawn in the JAX tool's order, and
    preprocess them in train mode on ``device`` -> (the batch, model
    points, [(R, t)]). The DZI boxes are ``generator``'s draws, or
    ``center_scale``."""
    from ..data.assets import cube_points, fps_numpy
    from ..data.pipeline import preprocess_batch
    from ..data.synthetic import _rodrigues, render_cube_depth

    K = K_OVERFIT
    if mesh == "cube":
        pts = cube_points(n_per_edge=9)
        extent = np.array([0.1, 0.1, 0.1], np.float32)
    else:
        from ..ops.rasterizer import render_mesh

        verts, faces = tetra_mesh()
        pts = verts
        extent = (verts.max(0) - verts.min(0)).astype(np.float32)
    fps = pts[fps_numpy(pts, num_regions)]
    rng = np.random.RandomState(seed)
    samples, poses = [], []
    for _ in range(n_views):
        R = _rodrigues(rng.randn(3) * 0.8).astype(np.float32)
        t = np.array([rng.uniform(-0.08, 0.08), rng.uniform(-0.06, 0.06),
                      rng.uniform(0.5, 1.0)], np.float32)
        if mesh == "cube":
            depth, xyz = render_cube_depth(R, t, K, H, W, n_samples=160)
            mask = (depth > 0).astype(np.float32)
            rgb = np.dstack([mask * 180 + 40] * 3) \
                + rng.rand(H, W, 3).astype(np.float32) * 30
        else:
            depth, xyz = render_mesh(verts, faces, K, R, t, H, W)
            mask = (depth > 0).astype(np.float32)
            # NOCS-style albedo: RGB carries model-coordinate signal
            albedo = (xyz / extent + 0.5) * 175.0 + 40.0
            rgb = np.where(mask[..., None] > 0, albedo,
                           rng.rand(H, W, 3) * 60.0)
        ys, xs = np.nonzero(mask)
        proj = K @ t
        samples.append({
            "rgb": rgb.astype(np.float32), "depth": depth, "xyz": xyz,
            "mask_visib": mask, "K": K,
            "bbox": np.array([xs.min(), ys.min(), xs.max(), ys.max()],
                             np.float32),
            "gt_rot": R, "gt_trans": t, "fps": fps.astype(np.float32),
            "extent": extent,
            "centroid_2d": (proj[:2] / proj[2]).astype(np.float32),
        })
        poses.append((R, t))
    dev = torch.device(device)
    batch = preprocess_batch(
        cfg, {k: torch.from_numpy(np.stack([s[k] for s in samples])).to(dev)
              for k in samples[0]},
        train=True, generator=generator, center_scale=center_scale)
    b = n_views
    batch["roi_points"] = torch.from_numpy(np.tile(
        pts[rng.choice(len(pts), 256)][None], (b, 1, 1))).to(dev)
    batch["sym_rots"] = torch.from_numpy(np.tile(
        np.eye(3, dtype=np.float32), (b, 4, 1, 1))).to(dev)
    batch["roi_cls"] = torch.zeros(b, dtype=torch.long, device=dev)
    return batch, pts, poses


def cube_sym_rotations() -> np.ndarray:
    """All 24 proper rotations of the cube (the octahedral group): signed
    axis permutations with determinant +1."""
    rots = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1.0, -1.0), repeat=3):
            R = np.zeros((3, 3), np.float32)
            for i, (p, s) in enumerate(zip(perm, signs)):
                R[i, p] = s
            if np.linalg.det(R) > 0:
                rots.append(R)
    assert len(rots) == 24
    return np.stack(rots)


def config_opts(args) -> list[str]:
    """The JAX tool's config overrides; ``--small`` also turns amp off,
    since the JAX tool's small model runs in float32."""
    opts = ["solver.warmup_iters=10", f"solver.base_lr={args.lr}",
            f"train.seed={args.seed}",
            f'train.output_dir="{args.out}"', "train.log_period=25",
            "data.color_aug_prob=0.0",
            # a 300-step overfit cannot move the reference tiny init (its
            # gradients start ~1e-5-scale): the gate tests the pipeline
            f'head.init="{args.init}"']
    if args.small:
        opts += ["backbone.depth=18", "backbone.input_res=64",
                 "head.out_res=16", "head.num_regions=8",
                 "head.num_filters=32", "data.input_res=64",
                 "data.out_res=16", "solver.amp=false"]
    return opts


def eval_modes(args, cfg, model, batch, dtype):
    """[(tag, model, autocast, use_kabsch)] in the JAX tool's order; the
    int8 models are serving copies of ``model``'s weights in ``dtype``,
    the static ones calibrated on ``batch``."""
    from ..models import RDPN
    from ..models.quant import calibrate_quant

    autocast = dtype if dtype != torch.float32 else None
    modes = [("bf16", model, autocast, False)]
    if args.kabsch:
        modes.append(("bf16+kabsch", model, autocast, True))
    if not args.int8:
        return modes
    dev = next(model.parameters()).device

    def copy(gran, static=False):
        m = RDPN(cfg, int8=gran, int8_static=static).to(device=dev,
                                                         dtype=dtype)
        m.load_state_dict(model.state_dict())    # copy_ casts as .to does
        return m.eval()

    grans = ["all", "trunk", "head"]
    if args.int8_stages:
        grans += [f"trunk{s}" for s in range(4)]
    for gran in grans:
        modes.append((f"int8-{gran}", copy(gran), None, False))
    # static calibrated scales, then per-input-channel ones absorbed into
    # the weights (the rescue attempt for the trunk modes)
    for gran, static in (("all", True), ("head", True),
                         ("all", "per_channel"), ("trunk", "per_channel")):
        m = copy(gran, static)
        calibrate_quant(m, [batch])
        sfx = "static" if static is True else "staticpc"
        modes.append((f"int8-{gran}-{sfx}", m, None, False))
    return modes


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--n-views", type=int, default=16)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "overfit_synth"))
    p.add_argument("--small", action="store_true",
                   help="tiny model (CPU-friendly)")
    p.add_argument("--int8", action="store_true",
                   help="also evaluate the trained weights through the "
                        "W8A8 int8 serving modes (models/quant.py)")
    p.add_argument("--kabsch", action="store_true",
                   help="also evaluate with the RANSAC-Kabsch refinement "
                        "(ops/ransac_kabsch.py)")
    p.add_argument("--mesh", choices=("cube", "tetra"), default="cube",
                   help="cube = 24-fold symmetric solid (rotation only "
                        "identifiable up to symmetry); tetra = irregular "
                        "ASYMMETRIC mesh, the rig for judging whether the "
                        "Kabsch refinement helps real rotations")
    p.add_argument("--init", choices=("fan_in", "reference"),
                   default="fan_in",
                   help="head/PnP init: the gate uses fan_in (the "
                        "reference normal(0.001) init cannot learn "
                        "rotation in 300 steps)")
    p.add_argument("--lr", type=float, default=0.0003)
    p.add_argument("--seed", type=int, default=0,
                   help="scene-render + train seed")
    p.add_argument("--int8-stages", action="store_true",
                   help="with --int8: also evaluate trunk0..trunk3 (one "
                        "trunk stage quantized at a time)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run(args, init=None) -> dict:
    """Train and evaluate as ``main`` does, printing the same lines.
    ``init(model)`` replaces the seeded init. Returns {results: {tag:
    per-object record}, cfg, model (trained, eval mode), batch, poses,
    step_ms, losses (each step's metrics), wall_s, peak_mb}."""
    from ..config import Config
    from ..engine.trainer import Trainer
    from ..evaluation.evaluator import PoseEvaluator, format_table
    from ..models import RDPN, init_weights
    from ..parallel import make_eval_step
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    t_start = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = Config().apply_opts(config_opts(args))
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    batch, model_pts, poses = build_scenes(
        cfg, args.n_views, cfg.head.num_regions, seed=args.seed,
        mesh=args.mesh, device=dev, generator=gen)
    model = RDPN(cfg)
    if init is None:
        init_weights(model, torch.Generator().manual_seed(args.seed))
    else:
        init(model)
    trainer = Trainer(cfg, model, total_iters=args.steps, device=dev)
    stamps: list[float] = []
    losses: list[dict] = []

    def stamp(it, metrics):
        if cuda:
            torch.cuda.synchronize(dev)
        stamps.append(time.perf_counter())
        losses.append(metrics)

    t0 = time.perf_counter()
    state = trainer.train(itertools.repeat(batch), start_iter=0,
                          step_hook=stamp)
    step_ms = list(1e3 * np.diff([t0] + stamps))
    losses = [{k: float(v) for k, v in m.items()} for m in losses]
    model = state.model.eval()

    dtype = torch.float32 if args.small else torch.bfloat16
    if args.mesh == "cube":
        # sym-aware: the refinement may settle on an equivalent orientation
        sym = cube_sym_rotations()
    else:
        # no symmetry bank: re/proj judge the true rotation
        sym = np.eye(3, dtype=np.float32)[None]
    d2 = ((model_pts[:, None] - model_pts[None]) ** 2).sum(-1)
    diameter = float(np.sqrt(d2.max()))
    results = {}
    for tag, eval_model, autocast, use_kabsch in eval_modes(
            args, cfg, model, batch, dtype):
        ecfg = cfg.apply_opts(["test.use_pnp=true",
                               'test.pnp_type="ransac_kabsch"']) \
            if use_kabsch else cfg
        out = make_eval_step(ecfg, eval_model, autocast=autocast)(batch)
        ev = PoseEvaluator(models={args.mesh: model_pts},
                           diameters={args.mesh: diameter},
                           sym_rots={args.mesh: sym}, device=dev)
        R_est = out["rot_ego"].float().cpu().numpy()
        t_est = out["trans"].float().cpu().numpy()
        cams = batch["roi_cam"].cpu().numpy()
        for i, (R, t) in enumerate(poses):
            ev.process(args.mesh, R_est[i], t_est[i], R, t, cams[i],
                       im_id=i)
        res = ev.evaluate()
        print(format_table(res))
        rec = res["per_obj"][args.mesh]
        results[tag] = rec
        print(f"RESULT[{tag}] ad_10={rec['ad_10']:.1f} "
              f"re_5={rec['re_5']:.1f} te_2={rec['te_2']:.1f} "
              f"AUCad={rec['AUCad']:.1f}", flush=True)
    wall = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20 if cuda \
        else float("nan")
    timed = step_ms[2:] or step_ms
    print(f"overfit: {args.mesh}, {args.n_views} views, {args.steps} steps "
          f"on {dev}: ms/step median {np.median(timed):.2f} over steps "
          f"{min(3, len(step_ms))}-{len(step_ms)}, run wall {wall:.1f} s, "
          f"peak device memory {peak:.0f} MB", flush=True)
    return {"results": results, "cfg": cfg, "model": model, "batch": batch,
            "poses": poses, "step_ms": step_ms, "losses": losses,
            "wall_s": wall,
            "peak_mb": peak}


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return run(args)["results"]


if __name__ == "__main__":
    main()
