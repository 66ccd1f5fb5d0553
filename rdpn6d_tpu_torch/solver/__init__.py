"""Optimizers and LR schedules.

Counterpart of ``rdpn6d_tpu/solver/__init__.py`` (``build_schedule``,
``build_optimizer``) for every optimizer name the JAX package builds; an
unknown name raises ValueError, as there. ``solver.max_grad_norm`` clips
by the global norm before the update (``clip_by_global_norm_``, which the
train step calls), and ``backbone.freeze`` leaves the ResNet trunk out of
the optimizer (the fusion net under ``backbone.spatial_net`` still trains,
as in the JAX package, whose mask covers its ``backbone`` subtree only).

The train step writes ``schedule(schedule_step(cfg, step))`` into the
param groups before each update: the JAX package's optax chains read the
schedule at the 0-based update count, but its ``ralamb`` (so
``rangerlars``), ``adamp`` and ``sgdp`` read it at their own 1-based count
unless ``solver.host_lr`` injects ``schedule(step)`` for every name.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
from torch import nn

from ..config import Config
from .optax_rules import SGDGC, AdaBelief, RMSpropTF
from .projection import SGDP, AdamP, project_scale_invariant
from .ranger import (Lookahead, RAdam, Ralamb, Ranger, centralize_,
                     radam_step_size)
from .schedule import flat_and_anneal, warmup_multistep

__all__ = ["Ranger", "RAdam", "Ralamb", "Lookahead", "AdamP", "SGDP",
           "RMSpropTF", "AdaBelief", "SGDGC", "centralize_",
           "radam_step_size", "project_scale_invariant", "flat_and_anneal",
           "warmup_multistep", "build_schedule", "build_optimizer",
           "schedule_step", "trainable_parameters", "clip_by_global_norm_",
           "global_norm"]

# names whose JAX update reads the schedule at its own 1-based count
ONE_BASED_LR = ("ralamb", "rangerlars", "over9000", "adamp", "sgdp")


def build_schedule(cfg: Config, total_iters: int) -> Callable[[int], float]:
    s = cfg.solver
    if s.lr_scheduler == "flat_and_anneal":
        return flat_and_anneal(
            s.base_lr, total_iters, warmup_iters=s.warmup_iters,
            warmup_factor=s.warmup_factor, anneal_point=s.anneal_point,
            anneal_method=s.anneal_method)
    if s.lr_scheduler == "warmup_multistep":
        return warmup_multistep(
            s.base_lr, milestones=(int(total_iters * 2 / 3),
                                   int(total_iters * 8 / 9)),
            warmup_iters=s.warmup_iters, warmup_factor=s.warmup_factor)
    raise ValueError(s.lr_scheduler)


def trainable_parameters(cfg: Config, model: nn.Module
                         ) -> list[tuple[str, nn.Parameter]]:
    """(name, parameter) pairs the optimizer updates."""
    def frozen(name: str) -> bool:
        return cfg.backbone.freeze and name.startswith("backbone.") \
            and not name.startswith("backbone.spatial_net.")

    return [(n, p) for n, p in model.named_parameters() if not frozen(n)]


def schedule_step(cfg: Config, step: int) -> int:
    """The schedule index whose lr the update of train step ``step``
    (0-based) applies, as in the JAX package (module docstring)."""
    s = cfg.solver
    return step + 1 if s.optimizer in ONE_BASED_LR and not s.host_lr \
        else step


def build_optimizer(cfg: Config, model: nn.Module,
                    lr: float | None = None) -> torch.optim.Optimizer:
    """The configured optimizer over ``trainable_parameters``; ``lr`` is
    the starting value (the train step overwrites it every step with the
    schedule's value at ``schedule_step``). The hyperparameters are the
    JAX package's (``rdpn6d_tpu/solver/__init__.py``): its optax
    defaults, and ``solver.weight_decay`` for ranger, ranger_adabelief,
    adamp, sgdp, ralamb, rangerlars and adamw only."""
    s = cfg.solver
    params = [p for _, p in trainable_parameters(cfg, model)]
    lr = s.base_lr if lr is None else lr
    wd = s.weight_decay
    name = s.optimizer
    if name == "ranger":
        return Ranger(params, lr=lr, weight_decay=wd)
    if name == "ranger_adabelief":
        return Ranger(params, lr=lr, weight_decay=wd, belief=True)
    if name == "adamp":
        return AdamP(params, lr=lr, weight_decay=wd)
    if name == "sgdp":
        return SGDP(params, lr=lr, weight_decay=wd)
    if name == "ralamb":
        return Ralamb(params, lr=lr, weight_decay=wd, f32_lr=not s.host_lr)
    if name in ("rangerlars", "over9000"):
        return Lookahead(Ralamb(params, lr=lr, weight_decay=wd,
                                f32_lr=not s.host_lr))
    if name == "rmsprop_tf":
        return RMSpropTF(params, lr=lr)
    if name == "sgd_gcc":
        return SGDGC(params, lr=lr, conv_only=True)
    if name == "sgd_gc":
        return SGDGC(params, lr=lr)
    if name == "radam":
        return RAdam(params, lr=lr)
    if name == "adabelief":
        return AdaBelief(params, lr=lr)
    if name == "lookahead_adam":
        return Lookahead(torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                          eps=1e-8))
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=wd)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    raise ValueError(name)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    ts = [t for t in tensors if t is not None]
    if not ts:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ts)))


def clip_by_global_norm_(params: Iterable[nn.Parameter],
                         max_norm: float) -> None:
    """Scale the gradients by max_norm / norm where their global norm is
    at least max_norm (optax.clip_by_global_norm); no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
