"""Training loop.

Counterpart of ``rdpn6d_tpu/engine/trainer.py:Trainer``, on one device:
the iteration loop over a batch iterator, one schedule shared by the
optimizer and the logged lr, the lag-1 NaN guard, the forced finiteness
check at every checkpoint iteration, and console logging. A raw grouped
batch (``{"frames", "rois"}``) is preprocessed with ``train=True`` on the
device first, the DZI draws coming from the trainer's seeded generator.

Not ported yet (ROADMAP): checkpoint saving and resume, the JSON and
TensorBoard writers, TRAIN2 mixing, eval during training, DDP.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import preprocess_rois_grouped
from ..models import RDPN
from ..parallel import TrainState, create_train_state, make_train_step
from ..solver import build_schedule
from ..utils.device import resolve_device

logger = logging.getLogger("rdpn6d")


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=True)
    return tree


class Trainer:
    def __init__(self, cfg: Config, model: RDPN, total_iters: int,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.total_iters = total_iters
        # ONE schedule drives both the optimizer and the logged lr
        self.schedule = build_schedule(cfg, total_iters)
        self.state: TrainState = create_train_state(
            cfg, self.model, lr=self.schedule(0))
        self.step_fn = make_train_step(cfg, self.schedule)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.train.seed)

    def train(self, loader: Iterator[dict], start_iter: int = 0,
              step_hook: Callable[[int, dict], None] | None = None
              ) -> TrainState:
        """Run iterations start_iter..total_iters-1. Each batch is either
        preprocessed train tensors or a raw grouped ``{"frames", "rois"}``
        batch (numpy or tensors). ``step_hook(it, metrics)`` runs after
        each step, with the step's device metrics."""
        cfg = self.cfg
        ckpt_period = max(int(self.total_iters
                              * cfg.train.checkpoint_period_epochs
                              / max(cfg.solver.total_epochs, 1)), 1)
        prev = None           # (iter, total_loss) for the lag-1 guard
        t0, first = time.perf_counter(), start_iter
        for it in range(start_iter, self.total_iters):
            batch = _to_device(next(loader), self.device)
            if "rois" in batch:
                batch = preprocess_rois_grouped(
                    cfg, batch["frames"], batch["rois"], train=True,
                    generator=self.generator)
            self.state, metrics = self.step_fn(self.state, batch)
            if step_hook is not None:
                step_hook(it, metrics)

            # the previous step has finished by the time this one is
            # queued, so reading its loss costs little; a NaN poisons at
            # most nan_guard_period updates
            if prev is not None \
                    and it % max(cfg.train.nan_guard_period, 1) == 0:
                p_it, p_total = prev
                if not np.isfinite(float(p_total)):
                    raise FloatingPointError(
                        f"non-finite total loss at iter {p_it}")
            prev = (it, metrics["total_loss"])

            if (it + 1) % cfg.train.log_period == 0 or it == start_iter:
                host = {k: float(v) for k, v in metrics.items()}
                if not np.isfinite(host["total_loss"]):
                    raise FloatingPointError(
                        f"non-finite total loss at iter {it}: {host}")
                rate = (time.perf_counter() - t0) / max(it + 1 - first, 1)
                losses = "  ".join(f"{k}: {v:.4f}"
                                   for k, v in sorted(host.items())
                                   if k.startswith("loss")
                                   or k == "total_loss")
                logger.info(
                    f"iter {it + 1}/{self.total_iters}  eta "
                    f"{rate * (self.total_iters - it - 1) / 60:.1f}m  "
                    f"{rate:.3f}s/it  lr {self.schedule(it):.2e}  {losses}")

            if (it + 1) % ckpt_period == 0 or (it + 1) == self.total_iters:
                # a checkpoint iteration (saving is not ported yet): this
                # step's loss is checked now, not a step later, so a NaN
                # is never the state a checkpoint would keep
                if not np.isfinite(float(metrics["total_loss"])):
                    raise FloatingPointError(
                        f"non-finite total loss at iter {it} at a "
                        "checkpoint iteration")
                prev = None
        return self.state
