"""Optimizers and LR schedules.

Counterpart of ``rdpn6d_tpu/solver/__init__.py`` (``build_schedule``,
``build_optimizer``) for the names ``ranger``, ``adam``, ``adamw`` and
``sgd``; the other names the JAX package knows raise NotImplementedError.
``solver.max_grad_norm`` clips by the global norm before the update
(``clip_by_global_norm_``, which the train step calls), and
``backbone.freeze`` leaves the ResNet trunk out of the optimizer (the
fusion net under ``backbone.spatial_net`` still trains, as in the JAX
package, whose mask covers its ``backbone`` subtree only).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
from torch import nn

from ..config import Config
from .ranger import Ranger, centralize_, radam_step_size
from .schedule import flat_and_anneal, warmup_multistep

__all__ = ["Ranger", "centralize_", "radam_step_size", "flat_and_anneal",
           "warmup_multistep", "build_schedule", "build_optimizer",
           "trainable_parameters", "clip_by_global_norm_", "global_norm"]


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


def build_optimizer(cfg: Config, model: nn.Module,
                    lr: float | None = None) -> torch.optim.Optimizer:
    """The configured optimizer over ``trainable_parameters``; ``lr`` is
    the starting value (the train step overwrites it every step, so
    ``solver.host_lr``, the JAX package's way to keep the lr out of the
    compiled step, has nothing left to do here)."""
    s = cfg.solver
    params = [p for _, p in trainable_parameters(cfg, model)]
    lr = s.base_lr if lr is None else lr
    if s.optimizer == "ranger":
        return Ranger(params, lr=lr, weight_decay=s.weight_decay)
    if s.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if s.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=s.weight_decay)
    if s.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    raise NotImplementedError(f"solver.optimizer={s.optimizer!r} is not "
                              "ported (ranger | adam | adamw | sgd)")


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
