"""Pose-error metrics: ADD, ADI, re, te, proj on batched torch tensors.

Counterpart of ``rdpn6d_tpu/evaluation/pose_error.py`` (add, adi, re_deg,
te, proj_2d, and the host numpy/scipy exact versions add_np ... proj_2d_np
for one pose, which nothing on the eval path calls). ADI's nearest-neighbour search is the ``min_dist2`` kernel
(``ops/min_dist.py``): on CUDA tensors the hand-written CUDA kernel, on CPU
tensors its plain version. Shapes: R [..., 3, 3], t [..., 3],
pts [..., N, 3] (broadcast against the poses' leading dims).
"""

from __future__ import annotations

import math

import numpy as np
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


# ---------------------------------------------------------------------------
# host (numpy/scipy) exact versions, one pose at a time
# ---------------------------------------------------------------------------

def add_np(R_est, t_est, R_gt, t_gt, pts) -> float:
    pe = pts @ R_est.T + t_est
    pg = pts @ R_gt.T + t_gt
    return float(np.linalg.norm(pe - pg, axis=1).mean())


def adi_np(R_est, t_est, R_gt, t_gt, pts) -> float:
    from scipy import spatial

    pe = pts @ R_est.T + t_est
    pg = pts @ R_gt.T + t_gt
    nn, _ = spatial.cKDTree(pe).query(pg, k=1)
    return float(nn.mean())


def re_np(R_est, R_gt) -> float:
    cos = np.clip((np.trace(R_est.T @ R_gt) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(cos)))


def te_np(t_est, t_gt) -> float:
    return float(np.linalg.norm(np.asarray(t_est) - np.asarray(t_gt)))


def proj_2d_np(R_est, t_est, R_gt, t_gt, pts, K) -> float:
    def prj(R, t):
        p = (pts @ R.T + t) @ K.T
        return p[:, :2] / p[:, 2:3]

    return float(np.linalg.norm(prj(R_est, t_est) - prj(R_gt, t_gt),
                                axis=1).mean())
