"""Point-matching loss with symmetry awareness.

Counterpart of ``rdpn6d_tpu/losses/pm_loss.py``. The symmetric variant
takes, per sample, the symmetry-equivalent GT rotation closest to the
prediction (``geometry/symmetry.closest_rot`` over an identity-padded
bank). Every weighted term carries a factor 3 for the mean over the point
coordinates; the ``_noP`` terms carry neither the weight nor the 3, as the
reference's.
"""

from __future__ import annotations

import torch

from ..geometry import closest_rot, transform_pts
from .dense import batch_mean


def _elem_loss(diff: torch.Tensor, kind: str,
               beta: float = 1.0) -> torch.Tensor:
    if kind in ("L1", "l1"):
        return diff.abs()
    if kind in ("smooth_l1", "Smooth_L1"):
        a = diff.abs()
        return torch.where(a < beta, 0.5 * a * a / beta, a - 0.5 * beta)
    if kind in ("mse", "MSE"):
        return diff * diff
    raise ValueError(kind)


def point_matching_loss(
    pred_rots: torch.Tensor,
    gt_rots: torch.Tensor,
    points: torch.Tensor,
    pred_trans: torch.Tensor | None = None,
    gt_trans: torch.Tensor | None = None,
    extents: torch.Tensor | None = None,
    sym_rots: torch.Tensor | None = None,
    loss_type: str = "L1",
    beta: float = 1.0,
    norm_by_extent: bool = False,
    symmetric: bool = False,
    r_only: bool = True,
    disentangle_t: bool = False,
    disentangle_z: bool = False,
    t_use_points: bool = False,
    loss_weight: float = 1.0,
    world: int = 1,
) -> dict[str, torch.Tensor]:
    """pred/gt rots [B,3,3]; points [B,N,3]; sym_rots [B,S,3,3]. With
    ``world`` > 1, this shard's share of the global batch's means
    (``dense.batch_mean``)."""
    if symmetric:
        if sym_rots is None:
            raise ValueError("symmetric PM loss needs sym_rots")
        gt_rots = closest_rot(pred_rots, gt_rots, sym_rots)

    pts_est = transform_pts(points, pred_rots)
    pts_tgt = transform_pts(points, gt_rots)

    if norm_by_extent:
        if extents is None:
            raise ValueError("pm_norm_by_extent needs extents")
        w = (1.0 / extents.amax(dim=-1))[:, None, None]
    else:
        w = 1.0

    def red(diff):
        return batch_mean(_elem_loss(diff, loss_type, beta), world)

    def weighted(diff):
        return 3.0 * red(w * diff) * loss_weight

    if r_only:
        return {"loss_PM_R": weighted(pts_est - pts_tgt)}

    if pred_trans is None or gt_trans is None:
        raise ValueError("PM loss with translation needs pred/gt trans")
    if disentangle_z:
        if t_use_points:
            tgt = pts_tgt + gt_trans[:, None, :]
            est_R = pts_est + gt_trans[:, None, :]
            t_xy = torch.cat([pred_trans[:, :2], gt_trans[:, 2:]], -1)
            t_z = torch.cat([gt_trans[:, :2], pred_trans[:, 2:]], -1)
            return {
                "loss_PM_R": weighted(est_R - tgt),
                "loss_PM_xy": weighted(pts_tgt + t_xy[:, None, :] - tgt),
                "loss_PM_z": weighted(pts_tgt + t_z[:, None, :] - tgt),
            }
        return {
            "loss_PM_R": weighted(pts_est - pts_tgt),
            "loss_PM_xy_noP": red(pred_trans[:, :2] - gt_trans[:, :2]),
            "loss_PM_z_noP": red(pred_trans[:, 2] - gt_trans[:, 2]),
        }
    if disentangle_t:
        if t_use_points:
            tgt = pts_tgt + gt_trans[:, None, :]
            return {
                "loss_PM_R": weighted(pts_est + gt_trans[:, None, :] - tgt),
                "loss_PM_T": weighted(pts_tgt + pred_trans[:, None, :]
                                      - tgt),
            }
        return {
            "loss_PM_R": weighted(pts_est - pts_tgt),
            "loss_PM_T_noP": red(pred_trans - gt_trans),
        }
    est = pts_est + pred_trans[:, None, :]
    tgt = pts_tgt + gt_trans[:, None, :]
    return {"loss_PM_RT": weighted(est - tgt)}
