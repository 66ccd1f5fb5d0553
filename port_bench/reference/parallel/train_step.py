"""The reference's train step and eval step: a frozen copy of
``rdpn6d_tpu_torch/parallel/train_step.py``'s one-process step (forward
in train mode, losses, backward, the global norm and clip, Ranger) and
eval step (the model in eval mode, the mask as a probability map), with
the reference's own precision: float32, bfloat16 autocast on request,
or the control's float8 mode around it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..config import Config
from ..losses import compute_losses
from ..models import RDPN, mask_prob
from ..solver import clip_by_global_norm_, global_norm


@dataclass
class TrainState:
    model: RDPN
    optimizer: torch.optim.Optimizer
    step: int = 0


def _dropblock_kwargs(cfg: Config, step: int, device: torch.device) -> dict:
    if cfg.pnp.drop_prob <= 0:
        return {}
    gen = torch.Generator(device=device)
    gen.manual_seed((cfg.train.seed + 7) * 1_000_003 + step)
    return {"drop_scale": min(step / 5000.0, 1.0), "generator": gen}


def make_train_step(cfg: Config, schedule: Callable[[int], float]
                    ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """(state, batch[, bf16]) -> (state, metrics): every loss,
    ``total_loss`` and ``grad_norm`` (before clipping); the forward under
    bfloat16 autocast where ``bf16``, as the program's under
    ``solver.amp``."""
    def step_fn(state: TrainState, batch: dict, bf16: bool = False
                ) -> tuple[TrainState, dict]:
        model, opt = state.model, state.optimizer
        dev = next(model.parameters()).device
        model.train()
        lr = schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16):
            out = model(batch, **_dropblock_kwargs(cfg, state.step, dev))
        losses = compute_losses(cfg, out, batch)
        total = sum(losses.values())
        total.backward()
        grad_norm = global_norm(p.grad for p in model.parameters())
        if cfg.solver.max_grad_norm > 0:
            clip_by_global_norm_(model.parameters(), cfg.solver.max_grad_norm)
        opt.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return step_fn


def make_eval_step(cfg: Config, model: RDPN
                   ) -> Callable[[dict], dict[str, torch.Tensor]]:
    """(batch) -> rot_ego, trans, mask_prob, coord, region_logits."""
    def eval_fn(batch: dict) -> dict[str, torch.Tensor]:
        with torch.no_grad():
            out = model(batch)
            prob = mask_prob(out["mask_logits"].permute(0, 3, 1, 2),
                             cfg.head.mask_loss)[:, 0]
        return {"rot_ego": out["rot_ego"], "trans": out["trans"],
                "mask_prob": prob, "coord": out["coord"],
                "region_logits": out["region_logits"]}

    return eval_fn
