"""Dense-map losses: masked coordinate, mask and region losses.

Counterpart of ``rdpn6d_tpu/losses/dense.py``. Channels last, as the
model's outputs. Coordinate and region losses are sum-reduced and divided
by the foreground pixel count (clamped to >= 1); the mask loss and
``loss_region_my`` are means over all pixels.

Under data parallelism each rank computes its share of the global batch's
loss: masked sums over the all-reduced pixel count (``denom``), means as
sums over the global element count (``world`` equal shards), so that the
shares sum to the loss of the whole batch and so do their gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ce_int(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel softmax cross entropy over the last axis with integer
    labels: logsumexp(logits) - logits[label]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def batch_mean(x: torch.Tensor, world: int = 1) -> torch.Tensor:
    """The mean of ``x``, or with ``world`` > 1 equal shards of a global
    batch this shard's share of the global mean: its sum over the global
    element count."""
    return x.mean() if world == 1 else x.sum() / (x.numel() * world)


def masked_coord_l1(pred: torch.Tensor, target: torch.Tensor,
                    mask: torch.Tensor, denom: torch.Tensor | None = None
                    ) -> dict[str, torch.Tensor]:
    """Per-axis masked L1. pred/target [B,H,W,3]; mask [B,H,W]; ``denom``
    the global batch's clamped pixel count (default this batch's)."""
    denom = mask.sum().clamp_min(1.0) if denom is None else denom
    diff = (pred - target).abs() * mask[..., None]
    return {f"loss_coor_{a}": diff[..., i].sum() / denom
            for i, a in enumerate("xyz")}


def masked_coord_ce(coord_logits: torch.Tensor, target_bins: torch.Tensor,
                    mask: torch.Tensor, num_bins: int,
                    denom: torch.Tensor | None = None
                    ) -> dict[str, torch.Tensor]:
    """Bin-classification coordinate loss (CE_coor). coord_logits
    [B,H,W,3*(num_bins+1)]; target_bins [B,H,W,3] int; mask [B,H,W].
    Masked pixels contribute nothing (the reference masks the logits,
    which differs by a parameter-free constant)."""
    denom = mask.sum().clamp_min(1.0) if denom is None else denom
    n = num_bins + 1
    return {f"loss_coor_{a}": (_ce_int(coord_logits[..., i * n:(i + 1) * n],
                                       target_bins[..., i]) * mask).sum()
            / denom for i, a in enumerate("xyz")}


def mask_loss(mask_logits: torch.Tensor, gt_mask: torch.Tensor,
              kind: str = "L1", world: int = 1) -> torch.Tensor:
    """mask_logits [B,H,W,Dm]; gt_mask [B,H,W]."""
    if kind == "L1":
        return batch_mean((mask_logits[..., 0] - gt_mask).abs(), world)
    if kind == "BCE":
        return batch_mean(F.binary_cross_entropy_with_logits(
            mask_logits[..., 0], gt_mask, reduction="none"), world)
    if kind == "CE":
        return batch_mean(_ce_int(mask_logits, gt_mask.long()), world)
    raise ValueError(kind)


def region_loss(region_logits: torch.Tensor, gt_region: torch.Tensor,
                mask: torch.Tensor, gt_mask_visib: torch.Tensor,
                denom: torch.Tensor | None = None, world: int = 1
                ) -> dict[str, torch.Tensor]:
    """Masked region CE, plus RDPN's L1 between the visibility mask and
    the RAW background logit (``loss_region_my``: no sigmoid, as the
    reference). region_logits [B,H,W,K+1]; gt_region [B,H,W] in 0..K."""
    denom = mask.sum().clamp_min(1.0) if denom is None else denom
    ce = _ce_int(region_logits, gt_region)
    return {
        "loss_region": (ce * mask).sum() / denom,
        "loss_region_my": batch_mean(
            (gt_mask_visib - region_logits[..., 0]).abs(), world),
    }
