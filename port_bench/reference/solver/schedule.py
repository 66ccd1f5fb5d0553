"""LR schedules: iteration -> learning rate.

Counterpart of ``rdpn6d_tpu/solver/schedule.py``: ``flat_and_anneal``
(linear warmup, flat until ``anneal_point`` of training, then a cosine /
linear / poly / exp anneal) and ``warmup_multistep``. Plain Python
functions of the iteration; the train step writes ``schedule(step)`` into
the optimizer's param groups before each update, as optax reads the
schedule at the update count (0 on the first step).
"""

from __future__ import annotations

import math
from typing import Callable


def flat_and_anneal(base_lr: float, total_iters: int, warmup_iters: int = 0,
                    warmup_factor: float = 0.001, anneal_point: float = 0.72,
                    anneal_method: str = "cosine",
                    target_lr_factor: float = 0.0,
                    poly_power: float = 1.0) -> Callable[[int], float]:
    if not 0.0 <= anneal_point <= 1.0:
        raise ValueError(f"anneal_point must be in [0, 1], "
                         f"got {anneal_point}")
    if anneal_method not in ("cosine", "linear", "poly", "exp", "none"):
        raise ValueError(anneal_method)
    anneal_start = anneal_point * total_iters

    def schedule(step: int) -> float:
        x = float(step)
        if x < warmup_iters:
            alpha = min(max(x / max(warmup_iters, 1), 0.0), 1.0)
            return base_lr * (warmup_factor * (1 - alpha) + alpha)
        if x < anneal_start:
            return base_lr
        frac = min(max((x - anneal_start)
                       / max(total_iters - anneal_start, 1.0), 0.0), 1.0)
        t = target_lr_factor
        if anneal_method == "cosine":
            af = t + 0.5 * (1 - t) * (1 + math.cos(math.pi * frac))
        elif anneal_method == "linear":
            af = t + (1 - t) * (1 - frac)
        elif anneal_method == "poly":
            af = t + (1 - t) * (1 - frac) ** poly_power
        elif anneal_method == "exp":
            af = max(t, 5e-3) ** frac
        else:
            af = 1.0
        return base_lr * af

    return schedule


def warmup_multistep(base_lr: float, milestones: tuple[int, ...],
                     gamma: float = 0.1, warmup_iters: int = 1000,
                     warmup_factor: float = 0.001) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        x = float(step)
        alpha = min(max(x / max(warmup_iters, 1), 0.0), 1.0)
        wf = warmup_factor * (1 - alpha) + alpha
        return base_lr * wf * gamma ** sum(x >= m for m in milestones)

    return schedule
