"""Training loop.

Counterpart of ``rdpn6d_tpu/engine/trainer.py:Trainer``: the iteration
loop over a batch iterator with TRAIN2 stochastic mixing,
one schedule shared by the optimizer and the logged lr, the lag-1 NaN
guard, the metric writers (console, ``metrics.json``, TensorBoard where it
imports) at every log period, checkpoints (``engine/checkpoint.py``) every
``train.checkpoint_period_epochs`` after a forced finiteness check, and
eval every ``train.eval_period`` iterations. A raw grouped batch
(``{"frames", "rois"}``) or a raw flat one (``{"samples"}``, the
``data.grouped_train=false`` path) is preprocessed with ``train=True`` on
the device first, the DZI draws coming from the trainer's seeded
generator. ``data.fused_train_step`` changes nothing here: the JAX
package's fused step removes a boundary between two compiled programs,
which eager PyTorch does not have, so ``parallel.make_fused_train_step``
is these same two calls (the same kernels, the same state), and the loop
keeps the preprocessed batch for its image panels.

In a process group (``parallel/mesh.py``) every rank runs this loop on its
own shard of each global batch through ``make_sharded_train_step``: the
weights start from rank 0's (``replicate``, also after ``resume``), the
DZI and colour-aug generator's seed is folded with the rank, the TRAIN2
draws stay the same on every rank (they pick the loader every rank
takes), the metrics and so the NaN guard are the global batch's, rank 0
alone writes the metrics and the checkpoints, and every rank evaluates.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import preprocess_batch, preprocess_rois_grouped
from ..models import RDPN
from ..parallel import (
    TrainState,
    create_train_state,
    make_sharded_train_step,
    make_train_step,
    mesh,
)
from ..solver import build_schedule
from ..utils.device import resolve_device
from .checkpoint import CheckpointManager
from .writers import ConsoleWriter, JsonWriter, MetricBuffer, TensorboardWriter

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
        self.model = mesh.replicate(model.to(self.device))
        self.total_iters = total_iters
        # ONE schedule drives both the optimizer and the logged lr
        self.schedule = build_schedule(cfg, total_iters)
        self.state: TrainState = create_train_state(
            cfg, self.model, lr=self.schedule(0))
        self.step_fn = (make_sharded_train_step if mesh.in_group()
                        else make_train_step)(cfg, self.schedule)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.train.seed
                                   + 1_000_003 * mesh.rank())
        out_dir = cfg.train.output_dir
        self.ckpt = CheckpointManager(f"{out_dir}/ckpt",
                                      cfg.train.max_to_keep)
        self.buf = MetricBuffer()
        self.console = ConsoleWriter(total_iters)
        self.json_writer = JsonWriter(f"{out_dir}/metrics.json")
        self.tb = TensorboardWriter(f"{out_dir}/tb")

    def resume(self) -> int:
        """Restore the latest checkpoint (model, optimizer, step), if any;
        returns the iteration to start at."""
        self.state, start = self.ckpt.resume_or_load(self.state, resume=True)
        mesh.replicate(self.model)
        if start:
            logger.info(f"resumed from iteration {start}")
        return start

    def train(self, loader: Iterator[dict], start_iter: int = 0,
              loader2: Iterator[dict] | None = None,
              train2_ratio: float = 0.0,
              eval_fn: Callable[[TrainState, int], None] | None = None,
              aux_metrics_fn: Callable[[], dict] | None = None,
              step_hook: Callable[[int, dict], None] | None = None
              ) -> TrainState:
        """Run iterations start_iter..total_iters-1. Each batch is either
        preprocessed train tensors, a raw grouped ``{"frames", "rois"}``
        batch or a raw flat ``{"samples"}`` one (numpy or tensors). With
        ``loader2``, each iteration draws from it with probability
        ``train2_ratio`` (the draws of ``RandomState(train.seed)``).
        ``aux_metrics_fn()`` adds host
        metrics to each log event; ``eval_fn(state, it)`` runs every
        ``train.eval_period`` iterations; ``step_hook(it, metrics)`` after
        each step, with the step's device metrics."""
        cfg = self.cfg
        rng = np.random.RandomState(cfg.train.seed)
        ckpt_period = max(int(self.total_iters
                              * cfg.train.checkpoint_period_epochs
                              / max(cfg.solver.total_epochs, 1)), 1)
        vis_period = cfg.train.log_period * 10
        prev = None           # (iter, total_loss) for the lag-1 guard
        for it in range(start_iter, self.total_iters):
            use2 = loader2 is not None and rng.rand() < train2_ratio
            batch = _to_device(next(loader2 if use2 else loader),
                               self.device)
            if "rois" in batch:
                batch = preprocess_rois_grouped(
                    cfg, batch["frames"], batch["rois"], train=True,
                    generator=self.generator)
            elif "samples" in batch:
                batch = preprocess_batch(cfg, batch["samples"], train=True,
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
                if aux_metrics_fn is not None:
                    host.update({k: float(v)
                                 for k, v in aux_metrics_fn().items()})
                self.buf.update(host)
                lr = float(self.schedule(it))
                self.console.write(it + 1, self.buf, lr)
                self.json_writer.write(it + 1, {**host, "lr": lr})
                self.tb.write(it + 1, host)

            if self.tb.enabled and (it + 1) % vis_period == 0:
                self._write_panels(it + 1, batch)

            if (it + 1) % ckpt_period == 0 or (it + 1) == self.total_iters:
                # this step's loss is checked now, not a step later: a NaN
                # is never the state a checkpoint keeps
                if not np.isfinite(float(metrics["total_loss"])):
                    raise FloatingPointError(
                        f"non-finite total loss at iter {it}: refusing "
                        "to checkpoint the poisoned state")
                prev = None
                self.ckpt.save(it + 1, self.state)
            if eval_fn is not None and cfg.train.eval_period > 0 \
                    and (it + 1) % cfg.train.eval_period == 0:
                eval_fn(self.state, it + 1)
        return self.state

    def _write_panels(self, step: int, batch: dict) -> None:
        """TensorBoard weight histograms (``train.tb_histograms``) and
        image panels of the first ROI: input RGB, depth xyz, GT coords and
        visible mask. Observability never stops training: a failure here is
        logged."""
        try:
            if self.cfg.train.tb_histograms:
                self.tb.write_histograms(step, {
                    k: v.detach().float().cpu().numpy()
                    for k, v in self.state.model.state_dict().items()
                    if v.is_floating_point()})
            img = batch["roi_img"][0].float().cpu().numpy()
            panels = {"input_rgb": img[..., :3],
                      "input_depth_xyz": img[..., 3:6]}
            if "roi_xyz" in batch:
                panels["gt_coord"] = batch["roi_xyz"][0].cpu().numpy()
                panels["gt_mask_visib"] = \
                    batch["roi_mask_visib"][0].cpu().numpy()
            self.tb.write_images(step, panels)
        except Exception:
            logger.exception(f"TensorBoard panels at iter {step} failed")
