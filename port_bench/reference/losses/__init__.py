"""Loss assembly of the reference train step: a frozen copy of
``rdpn6d_tpu_torch/losses/__init__.py``'s ``compute_losses`` in one
process.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..geometry import angular_distance
from .dense import (
    batch_mean,
    mask_loss,
    masked_coord_ce,
    masked_coord_l1,
    region_loss,
)
from .pm_loss import point_matching_loss

__all__ = ["compute_losses", "point_matching_loss", "masked_coord_l1",
           "masked_coord_ce", "mask_loss", "region_loss"]


def compute_losses(cfg: Config, out: dict[str, torch.Tensor],
                   batch: dict[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
    """All training losses; their sum is the objective.

    batch (train): roi_xyz [B,H,W,3] (or roi_xyz_bin), roi_mask_{trunc,
    visib,obj} [B,H,W], roi_region [B,H,W], gt_rot [B,3,3] (ego),
    gt_trans [B,3], trans_ratio [B,3], roi_points [B,N,3], sym_rots
    [B,S,3,3], roi_extent [B,3]. Computed in float32.
    """
    h, l, p = cfg.head, cfg.loss, cfg.pnp
    masks = {"trunc": batch["roi_mask_trunc"],
             "visib": batch["roi_mask_visib"],
             "obj": batch["roi_mask_obj"]}
    losses: dict[str, torch.Tensor] = {}
    n = 1
    denom = dict.fromkeys((h.xyz_loss_mask, h.region_loss_mask))

    xyz_mask = masks[h.xyz_loss_mask]
    if h.xyz_loss == "L1":
        coord = masked_coord_l1(out["coord"], batch["roi_xyz"], xyz_mask,
                                denom[h.xyz_loss_mask])
    elif h.xyz_loss == "CE_coor":
        coord = masked_coord_ce(out["coord_out"], batch["roi_xyz_bin"],
                                xyz_mask, h.xyz_bin, denom[h.xyz_loss_mask])
    else:
        raise ValueError(h.xyz_loss)
    losses.update({k: v * h.xyz_lw for k, v in coord.items()})

    losses["loss_mask"] = mask_loss(
        out["mask_logits"], masks[h.mask_loss_gt], h.mask_loss, n) \
        * h.mask_lw

    reg = region_loss(out["region_logits"], batch["roi_region"],
                      masks[h.region_loss_mask], batch["roi_mask_visib"],
                      denom[h.region_loss_mask], n)
    losses["loss_region"] = reg["loss_region"] * h.region_lw
    losses["loss_region_my"] = reg["loss_region_my"] * h.region_lw

    if l.pm_lw > 0:
        losses.update(point_matching_loss(
            out["rot_ego"], batch["gt_rot"], batch["roi_points"],
            pred_trans=out["trans"], gt_trans=batch["gt_trans"],
            extents=batch["roi_extent"], sym_rots=batch.get("sym_rots"),
            loss_type=l.pm_loss_type, beta=l.pm_smooth_l1_beta,
            norm_by_extent=l.pm_norm_by_extent, symmetric=l.pm_loss_sym,
            r_only=l.pm_r_only, disentangle_t=l.pm_disentangle_t,
            disentangle_z=l.pm_disentangle_z,
            t_use_points=l.pm_t_use_points, loss_weight=l.pm_lw,
            world=n))

    if l.rot_lw > 0:
        if l.rot_loss_type == "angular":
            # eps keeps arccos' gradient finite at cos = +-1
            losses["loss_rot"] = batch_mean(angular_distance(
                out["rot_ego"], batch["gt_rot"], eps=1e-7), n) * l.rot_lw
        else:
            losses["loss_rot"] = batch_mean(
                (out["rot_ego"] - batch["gt_rot"]) ** 2, n) * l.rot_lw

    if l.centroid_lw > 0 and p.trans_type == "centroid_z":
        losses["loss_centroid"] = batch_mean(
            (out["centroid_rel"] - batch["trans_ratio"][:, :2]).abs(), n) \
            * l.centroid_lw
    if l.z_lw > 0:
        losses["loss_z"] = batch_mean(
            (out["z_rel"] - batch["trans_ratio"][:, 2]).abs(), n) * l.z_lw

    if l.trans_lw > 0:
        diff = out["trans"] - batch["gt_trans"]
        if l.trans_loss_disentangle:
            losses["loss_trans_xy"] = batch_mean(diff[:, :2].abs(), n) \
                * l.trans_lw
            losses["loss_trans_z"] = batch_mean(diff[:, 2].abs(), n) \
                * l.trans_lw
        else:
            losses["loss_trans_LPnP"] = batch_mean(diff.abs(), n) \
                * l.trans_lw

    if l.bind_lw > 0:
        bind_pred = torch.einsum("bij,bi->bj", out["rot_ego"], out["trans"])
        bind_gt = torch.einsum("bij,bi->bj", batch["gt_rot"],
                               batch["gt_trans"])
        losses["loss_bind"] = batch_mean((bind_pred - bind_gt).abs(), n) \
            * l.bind_lw

    if l.use_mtl:
        for name in ("mask", "coor_x", "coor_y", "coor_z", "region"):
            key, s = f"loss_{name}", out.get(f"log_var_{name}")
            if key in losses and s is not None:
                # a rank's share of L exp(-s) + s
                losses[key] = losses[key] * torch.exp(-s) + s / n

    return losses
