"""The train step: forward (train mode), losses, backward, optimizer step.

Counterpart of ``rdpn6d_tpu/parallel/train_step.py`` (``TrainState``,
``create_train_state``, ``make_train_step`` and
``make_sharded_train_step`` around ``_make_step_fn``,
``make_fused_train_step`` and ``make_eval_step``), eager: the model
and the optimizer update in place, so the state is the live objects plus
the step count. Under ``solver.amp`` the forward runs in bf16 autocast
over float32 parameters, as the JAX model runs bf16 compute over float32
params; the logits, the pose and the losses stay float32. DropBlock's rate
ramps as min(step / 5000, 1), its draw seeded by (train.seed, step).

``make_sharded_train_step`` is the step of one rank of a process group
(``parallel/mesh.py``) on its equal shard of the global batch: BatchNorm
takes the global batch's statistics, each loss is the rank's share of the
global loss, the gradients are summed over the ranks in flat buckets
before the global norm, the clip and Ranger, and DropBlock draws one mask
over the global batch and keeps the rank's rows. N ranks take the step one
process takes on the global batch, as the JAX package's one program over
a batch-sharded mesh does; every rank ends with the same parameters.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable

import torch
import torch.distributed as dist

from ..config import Config
from ..solver import (build_optimizer, clip_by_global_norm_, global_norm,
                      schedule_step)
from .mesh import in_group, rank, world

if TYPE_CHECKING:
    from ..models import RDPN


@dataclass
class TrainState:
    model: RDPN
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(cfg: Config, model: RDPN,
                       lr: float | None = None) -> TrainState:
    """The state of a fresh run: ``model`` (already on its device) and the
    configured optimizer over its trainable parameters."""
    return TrainState(model=model,
                      optimizer=build_optimizer(cfg, model, lr=lr))


# the gradient all-reduce's bucket size
BUCKET_BYTES = 32 << 20


def _dropblock_kwargs(cfg: Config, step: int, device: torch.device,
                      sharded: bool = False) -> dict:
    if cfg.pnp.drop_prob <= 0:
        return {}
    gen = torch.Generator(device=device)
    gen.manual_seed((cfg.train.seed + 7) * 1_000_003 + step)
    kwargs = {"drop_scale": min(step / 5000.0, 1.0), "generator": gen}
    if sharded:
        kwargs["drop_shard"] = (rank(), world())
    return kwargs


def all_reduce_grads(params) -> None:
    """Sum the gradients of ``params`` over the ranks, in place: flat
    buckets of at most ``BUCKET_BYTES`` of one dtype, one all-reduce
    each, in parameter order (the same on every rank)."""
    buckets: list[list[torch.Tensor]] = []
    size = 0
    for g in (p.grad for p in params if p.grad is not None):
        nbytes = g.numel() * g.element_size()
        if not buckets or g.dtype != buckets[-1][0].dtype \
                or size + nbytes > BUCKET_BYTES:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += nbytes
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        for g, v in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(v.view_as(g))


def make_train_step(cfg: Config, schedule: Callable[[int], float]
                    ) -> Callable[[TrainState, dict],
                                  tuple[TrainState, dict]]:
    """(state, batch) -> (state, metrics). ``batch`` holds the
    preprocessed train tensors on the model's device; ``metrics`` maps
    every loss, ``total_loss`` and ``grad_norm`` (the global norm of the
    gradients before clipping) to device scalars, so the step does not
    wait for the device."""
    return _make_step_fn(cfg, schedule, sharded=False)


def make_fused_train_step(cfg: Config, schedule: Callable[[int], float]
                          ) -> Callable[..., tuple[TrainState, dict]]:
    """(state, frames, rois, generator) -> (state, metrics): the grouped
    path's ``preprocess_rois_grouped(train=True)`` and the step body in
    one call, ``data.fused_train_step``'s step (the counterpart of
    ``make_fused_sharded_train_step``). ``generator`` drives the DZI and
    colour-aug draws; ``center_scale`` may replace the DZI boxes, as in
    ``preprocess_rois_grouped``.

    The JAX package compiles the two into one program, so that the
    boundary between two programs puts no relayout of the input, and no
    second dispatch, between them. In eager PyTorch there is no such
    boundary: this step and the two calls it replaces launch the same
    kernels in the same order, and give the same state bit for bit. So
    ``Trainer`` makes the two calls whatever the option says (it keeps
    the preprocessed batch for its image panels), and this step serves
    ``tools.bench_train --grouped-ab`` and the parity with the JAX
    package's fused step.

    One process only (a process group of one included, whose step is the
    sharded body), as the JAX package selects it only for
    ``jax.process_count() == 1``: ranks of a larger group each hold other
    frames."""
    from ..data import pipeline

    if world() > 1:
        raise RuntimeError("make_fused_train_step runs in one process; "
                           f"this group has {world()}")
    step_fn = _make_step_fn(cfg, schedule, sharded=in_group())

    def fused(state: TrainState, frames: dict, rois: dict,
              generator: torch.Generator | None = None,
              center_scale: tuple | None = None
              ) -> tuple[TrainState, dict]:
        # looked up at each call, as the eval runner does
        batch = pipeline.preprocess_rois_grouped(
            cfg, frames, rois, train=True, generator=generator,
            center_scale=center_scale)
        return step_fn(state, batch)

    return fused


def make_eval_step(cfg: Config, model: RDPN,
                   autocast: torch.dtype | None = None
                   ) -> Callable[[dict], dict[str, torch.Tensor]]:
    """(batch) -> the eval outputs of the JAX package's ``make_eval_step``:
    ``rot_ego``, ``trans``, ``mask_prob`` [B,H,W] (the head's mask as a
    probability map), ``coord`` [B,H,W,3] and ``region_logits``, from the
    model in eval mode without gradients, its forward under autocast to
    ``autocast`` where given. With ``test.use_pnp`` and
    ``test.pnp_type="ransac_kabsch"`` the net pose
    seeds the RANSAC-Kabsch refinement (``ops/ransac_kabsch``, in float32,
    one kernel launch a batch on the card) over the dense correspondences
    and the depth crop's points (``roi_coord_2d``'s xyz), with the draws
    of ``hypothesis_draws`` for the batch's size: ``rot_ego`` and
    ``trans`` are the refined pose where its inlier ratio exceeds 0.05,
    and ``inlier_ratio`` [B] is added. ``test.use_pnp`` with
    ``pnp_type="net"`` serves the net pose."""
    from ..models import mask_prob
    from ..ops import ransac_kabsch as rk

    use_kabsch = cfg.test.use_pnp and cfg.test.pnp_type == "ransac_kabsch"

    def eval_fn(batch: dict) -> dict[str, torch.Tensor]:
        dev = batch["roi_img"].device
        with torch.no_grad():
            with torch.autocast(dev.type, dtype=autocast) if autocast \
                    else contextlib.nullcontext():
                out = model(batch)
            prob = mask_prob(out["mask_logits"].permute(0, 3, 1, 2),
                             cfg.head.mask_loss)[:, 0]
            result = {"rot_ego": out["rot_ego"], "trans": out["trans"],
                      "mask_prob": prob, "coord": out["coord"],
                      "region_logits": out["region_logits"]}
            if use_kabsch:
                b = out["coord"].shape[0]
                draws = rk.hypothesis_draws(b, rk.NUM_HYPS, rk.SAMPLE_SIZE,
                                            dev)
                ref = rk.refine_pose_kabsch(
                    out["coord"], out["region_logits"], prob,
                    batch["roi_coord_2d"][..., :3], batch["resize_ratio"],
                    batch["fps"], batch["roi_extent"], out["rot_ego"],
                    out["trans"], draws, mask_thr=cfg.head.mask_thr_test)
                result.update(rot_ego=ref.R, trans=ref.t,
                              inlier_ratio=ref.ratio)
        return result

    return eval_fn


def make_sharded_train_step(cfg: Config, schedule: Callable[[int], float]
                            ) -> Callable[[TrainState, dict],
                                          tuple[TrainState, dict]]:
    """``make_train_step`` for one rank of a process group on its equal
    shard of the global batch (module docstring); the metrics are the
    global batch's, the same on every rank."""
    if not in_group():
        raise RuntimeError("make_sharded_train_step needs a process group "
                           "(parallel.mesh.init_distributed)")
    return _make_step_fn(cfg, schedule, sharded=True)


def _make_step_fn(cfg: Config, schedule: Callable[[int], float],
                  sharded: bool) -> Callable[[TrainState, dict],
                                             tuple[TrainState, dict]]:
    # here, not at the top: the losses and the models import mesh, which
    # imports this package
    from ..losses import compute_losses

    def step_fn(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        model, opt = state.model, state.optimizer
        dev = next(model.parameters()).device
        model.train()
        lr = schedule(schedule_step(cfg, state.step))
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        with torch.autocast(dev.type, dtype=torch.bfloat16,
                            enabled=cfg.solver.amp):
            out = model(batch, **_dropblock_kwargs(cfg, state.step, dev,
                                                   sharded))
        losses = compute_losses(cfg, out, batch, sharded=sharded)
        total = sum(losses.values())
        total.backward()
        if sharded:
            all_reduce_grads(model.parameters())
        grad_norm = global_norm(p.grad for p in model.parameters())
        if cfg.solver.max_grad_norm > 0:
            clip_by_global_norm_(
                (p for g in opt.param_groups for p in g["params"]),
                cfg.solver.max_grad_norm)
        opt.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        if sharded:
            # every rank logs, guards and checkpoints on the same numbers
            values = torch.stack(list(metrics.values()))
            dist.all_reduce(values)
            metrics = dict(zip(metrics, values.unbind()))
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return step_fn
