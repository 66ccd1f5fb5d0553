"""Dense-map losses: masked coordinate, mask and region losses.

Counterpart of ``rdpn6d_tpu/losses/dense.py``. Channels last, as the
model's outputs. Coordinate and region losses are sum-reduced and divided
by the foreground pixel count (clamped to >= 1); the mask loss and
``loss_region_my`` are means over all pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ce_int(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel softmax cross entropy over the last axis with integer
    labels: logsumexp(logits) - logits[label]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def masked_coord_l1(pred: torch.Tensor, target: torch.Tensor,
                    mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-axis masked L1. pred/target [B,H,W,3]; mask [B,H,W]."""
    denom = mask.sum().clamp_min(1.0)
    diff = (pred - target).abs() * mask[..., None]
    return {f"loss_coor_{a}": diff[..., i].sum() / denom
            for i, a in enumerate("xyz")}


def masked_coord_ce(coord_logits: torch.Tensor, target_bins: torch.Tensor,
                    mask: torch.Tensor, num_bins: int
                    ) -> dict[str, torch.Tensor]:
    """Bin-classification coordinate loss (CE_coor). coord_logits
    [B,H,W,3*(num_bins+1)]; target_bins [B,H,W,3] int; mask [B,H,W].
    Masked pixels contribute nothing (the reference masks the logits,
    which differs by a parameter-free constant)."""
    denom = mask.sum().clamp_min(1.0)
    n = num_bins + 1
    return {f"loss_coor_{a}": (_ce_int(coord_logits[..., i * n:(i + 1) * n],
                                       target_bins[..., i]) * mask).sum()
            / denom for i, a in enumerate("xyz")}


def mask_loss(mask_logits: torch.Tensor, gt_mask: torch.Tensor,
              kind: str = "L1") -> torch.Tensor:
    """mask_logits [B,H,W,Dm]; gt_mask [B,H,W]."""
    if kind == "L1":
        return (mask_logits[..., 0] - gt_mask).abs().mean()
    if kind == "BCE":
        return F.binary_cross_entropy_with_logits(
            mask_logits[..., 0], gt_mask, reduction="mean")
    if kind == "CE":
        return _ce_int(mask_logits, gt_mask.long()).mean()
    raise ValueError(kind)


def region_loss(region_logits: torch.Tensor, gt_region: torch.Tensor,
                mask: torch.Tensor, gt_mask_visib: torch.Tensor
                ) -> dict[str, torch.Tensor]:
    """Masked region CE, plus RDPN's L1 between the visibility mask and
    the RAW background logit (``loss_region_my``: no sigmoid, as the
    reference). region_logits [B,H,W,K+1]; gt_region [B,H,W] in 0..K."""
    denom = mask.sum().clamp_min(1.0)
    ce = _ce_int(region_logits, gt_region)
    return {
        "loss_region": (ce * mask).sum() / denom,
        "loss_region_my": (gt_mask_visib - region_logits[..., 0]).abs()
        .mean(),
    }
