"""The train step: forward (train mode), losses, backward, optimizer step.

Counterpart of ``rdpn6d_tpu/parallel/train_step.py`` (``TrainState``,
``create_train_state``, ``make_train_step`` and
``make_sharded_train_step`` around ``_make_step_fn``, and
``make_eval_step``'s pose outputs without the RANSAC-Kabsch refinement),
eager: the model
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

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable

import torch
import torch.distributed as dist

from ..config import Config
from ..solver import build_optimizer, clip_by_global_norm_, global_norm
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


def make_eval_step(cfg: Config, model: RDPN
                   ) -> Callable[[dict], dict[str, torch.Tensor]]:
    """(batch) -> the eval outputs of the JAX package's ``make_eval_step``:
    ``rot_ego``, ``trans``, ``mask_prob`` [B,H,W] (the head's mask as a
    probability map), ``coord`` [B,H,W,3] and ``region_logits``, from the
    model in eval mode without gradients. ``test.use_pnp`` (the
    RANSAC-Kabsch refinement) is refused: ROADMAP queue 1 item 12."""
    from ..models import mask_prob

    if cfg.test.use_pnp:
        raise NotImplementedError("test.use_pnp: the RANSAC-Kabsch "
                                  "refinement is not ported (ROADMAP queue "
                                  "1 item 12)")

    def eval_fn(batch: dict) -> dict[str, torch.Tensor]:
        with torch.no_grad():
            out = model(batch)
        prob = mask_prob(out["mask_logits"].permute(0, 3, 1, 2),
                         cfg.head.mask_loss)[:, 0]
        return {"rot_ego": out["rot_ego"], "trans": out["trans"],
                "mask_prob": prob, "coord": out["coord"],
                "region_logits": out["region_logits"]}

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
        lr = schedule(state.step)
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
