"""The train step: forward (train mode), losses, backward, optimizer step.

Counterpart of ``rdpn6d_tpu/parallel/train_step.py`` (``TrainState``,
``create_train_state``, ``make_train_step`` around ``_make_step_fn``), on
one device and eager: the model and the optimizer update in place, so the
state is the live objects plus the step count. Under ``solver.amp`` the
forward runs in bf16 autocast over float32 parameters, as the JAX model
runs bf16 compute over float32 params; the logits, the pose and the losses
stay float32. DropBlock's rate ramps as min(step / 5000, 1), its draw
seeded by (train.seed, step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..config import Config
from ..losses import compute_losses
from ..models import RDPN
from ..solver import build_optimizer, clip_by_global_norm_, global_norm


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


def _dropblock_kwargs(cfg: Config, step: int,
                      device: torch.device) -> dict:
    if cfg.pnp.drop_prob <= 0:
        return {}
    gen = torch.Generator(device=device)
    gen.manual_seed((cfg.train.seed + 7) * 1_000_003 + step)
    return {"drop_scale": min(step / 5000.0, 1.0), "generator": gen}


def make_train_step(cfg: Config, schedule: Callable[[int], float]
                    ) -> Callable[[TrainState, dict],
                                  tuple[TrainState, dict]]:
    """(state, batch) -> (state, metrics). ``batch`` holds the
    preprocessed train tensors on the model's device; ``metrics`` maps
    every loss, ``total_loss`` and ``grad_norm`` (the global norm of the
    gradients before clipping) to device scalars, so the step does not
    wait for the device."""

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
            out = model(batch, **_dropblock_kwargs(cfg, state.step, dev))
        losses = compute_losses(cfg, out, batch)
        total = sum(losses.values())
        total.backward()
        grad_norm = global_norm(p.grad for p in model.parameters())
        if cfg.solver.max_grad_norm > 0:
            clip_by_global_norm_(
                (p for g in opt.param_groups for p in g["params"]),
                cfg.solver.max_grad_norm)
        opt.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return step_fn
