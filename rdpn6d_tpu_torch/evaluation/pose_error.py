"""Pose-error metrics: ADD, ADI, re, te, proj on batched torch tensors.

Counterpart of ``rdpn6d_tpu/evaluation/pose_error.py`` (add, adi, re_deg,
te, proj_2d). ADI's nearest-neighbour search is the ``min_dist2`` kernel
(``ops/min_dist.py``): on CUDA tensors the hand-written CUDA kernel, on CPU
tensors its plain version. Shapes: R [..., 3, 3], t [..., 3],
pts [..., N, 3] (broadcast against the poses' leading dims).
"""

from __future__ import annotations

import math

import torch

from ..geometry import angular_distance, project, transform_pts
from ..ops.min_dist import min_dist2


def add(R_est, t_est, R_gt, t_gt, pts) -> torch.Tensor:
    """Average model-point distance."""
    pe = transform_pts(pts, R_est, t_est)
    pg = transform_pts(pts, R_gt, t_gt)
    return torch.linalg.vector_norm(pe - pg, dim=-1).mean(-1)


def adi(R_est, t_est, R_gt, t_gt, pts) -> torch.Tensor:
    """Average closest-point distance (symmetric ADD): for each GT-posed
    point the distance to the nearest estimate-posed point."""
    pe = transform_pts(pts, R_est, t_est).float()
    pg = transform_pts(pts, R_gt, t_gt).float()
    lead = pg.shape[:-2]
    pe = pe.expand(lead + pe.shape[-2:]) if pe.shape[:-2] != lead else pe
    n, m = pg.shape[-2], pe.shape[-2]
    d2 = min_dist2(pg.reshape(-1, n, 3).contiguous(),
                   pe.reshape(-1, m, 3).contiguous()).reshape(lead + (n,))
    return d2.clamp_min(0.0).sqrt().mean(-1)


def re_deg(R_est, R_gt) -> torch.Tensor:
    """Rotation error in degrees."""
    return angular_distance(R_est, R_gt) * (180.0 / math.pi)


def te(t_est, t_gt) -> torch.Tensor:
    """Translation error (same unit as the inputs)."""
    return torch.linalg.vector_norm(t_est - t_gt, dim=-1)


def proj_2d(R_est, t_est, R_gt, t_gt, pts, K) -> torch.Tensor:
    """Mean 2-D reprojection distance in pixels."""
    pe = project(pts, K, R_est, t_est)
    pg = project(pts, K, R_gt, t_gt)
    return torch.linalg.vector_norm(pe - pg, dim=-1).mean(-1)
