"""The reference's optimizer, schedule and gradient norms: Ranger under
flat_and_anneal, as ``rdpn6d_tpu_torch/solver`` builds them for
``solver.optimizer="ranger"``."""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from ..config import Config
from .ranger import Ranger
from .schedule import flat_and_anneal


def build_schedule(cfg: Config, total_iters: int) -> Callable[[int], float]:
    s = cfg.solver
    if s.lr_scheduler != "flat_and_anneal":
        raise ValueError(f"the reference has flat_and_anneal only, not "
                         f"{s.lr_scheduler!r}")
    return flat_and_anneal(
        s.base_lr, total_iters, warmup_iters=s.warmup_iters,
        warmup_factor=s.warmup_factor, anneal_point=s.anneal_point,
        anneal_method=s.anneal_method)


def build_optimizer(cfg: Config, model: torch.nn.Module) -> Ranger:
    s = cfg.solver
    if s.optimizer != "ranger" or cfg.backbone.freeze:
        raise ValueError("the reference steps Ranger over every parameter")
    return Ranger(list(model.parameters()), lr=s.base_lr,
                  weight_decay=s.weight_decay)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    ts = [t for t in tensors if t is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ts)))


def clip_by_global_norm_(params: Iterable[torch.nn.Parameter],
                         max_norm: float) -> None:
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
