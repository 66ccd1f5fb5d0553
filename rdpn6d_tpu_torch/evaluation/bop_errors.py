"""BOP19 challenge errors: MSSD and MSPD, batched on torch tensors and on
host numpy for one (estimate, GT) pair.

Counterpart of ``rdpn6d_tpu/evaluation/bop_errors.py``: the batched
versions reduce min over the identity-padded symmetry banks of the max
over model points; the numpy versions are what the BOP19 scorer calls per
pair. VSD needs the depth rasterizer, which is not ported (ROADMAP queue 1
item 9).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import project, transform_pts


def _gt_sym_poses(R_gt, t_gt, sym_rots, sym_trans):
    """Symmetry-equivalent GT poses R = R_gt S_R, t = R_gt S_t + t_gt
    (BOP symmetries are full 4x4 transforms)."""
    R_gt_s = R_gt[..., None, :, :] @ sym_rots            # [..., S, 3, 3]
    if sym_trans is None:
        t_gt_s = t_gt[..., None, :].expand(R_gt_s.shape[:-2] + (3,))
    else:
        t_gt_s = torch.einsum("...ij,...sj->...si",
                              R_gt, sym_trans) + t_gt[..., None, :]
    return R_gt_s, t_gt_s


def mssd(R_est, t_est, R_gt, t_gt, pts, sym_rots,
         sym_trans=None) -> torch.Tensor:
    """Maximum symmetry-aware surface distance: [...,3,3], [...,3],
    pts [...,N,3], sym_rots [...,S,3,3] (identity-padded), sym_trans
    [...,S,3] (zero-padded, m) -> [...]."""
    pe = transform_pts(pts, R_est, t_est)                # [..., N, 3]
    R_gt_s, t_gt_s = _gt_sym_poses(R_gt, t_gt, sym_rots, sym_trans)
    pg = transform_pts(pts[..., None, :, :], R_gt_s, t_gt_s)
    d = torch.linalg.vector_norm(pe[..., None, :, :] - pg, dim=-1)
    return d.amax(-1).amin(-1)


def mspd(R_est, t_est, R_gt, t_gt, pts, sym_rots, K,
         sym_trans=None) -> torch.Tensor:
    """Maximum symmetry-aware projection distance (pixels)."""
    pe = project(pts, K, R_est, t_est)                   # [..., N, 2]
    R_gt_s, t_gt_s = _gt_sym_poses(R_gt, t_gt, sym_rots, sym_trans)
    pg = project(pts[..., None, :, :], K[..., None, :, :], R_gt_s, t_gt_s)
    d = torch.linalg.vector_norm(pe[..., None, :, :] - pg, dim=-1)
    return d.amax(-1).amin(-1)


def _np_gt_sym_poses(R_gt, t_gt, sym_rots, sym_trans):
    R_gt_s = R_gt[None] @ sym_rots                       # [S, 3, 3]
    t_gt_s = (sym_trans @ R_gt.T if sym_trans is not None
              else np.zeros((len(sym_rots), 3), R_gt.dtype)) + t_gt
    return R_gt_s, t_gt_s


def mssd_np(R_est, t_est, R_gt, t_gt, pts, sym_rots,
            sym_trans=None) -> float:
    """Host numpy mssd for ONE (estimate, GT) pair: the BOP19 scorer
    walks pairs in python, and a per-pair device dispatch + sync costs
    ~ms of relay latency each against ~us of host math (N~3k points)."""
    pe = pts @ R_est.T + t_est                           # [N, 3]
    R_gt_s, t_gt_s = _np_gt_sym_poses(R_gt, t_gt, sym_rots, sym_trans)
    pg = np.einsum("nj,sij->sni", pts, R_gt_s) + t_gt_s[:, None, :]
    d = np.linalg.norm(pe[None] - pg, axis=-1)           # [S, N]
    return float(d.max(axis=1).min())


def mspd_np(R_est, t_est, R_gt, t_gt, pts, sym_rots, K,
            sym_trans=None) -> float:
    """Host numpy mspd for one pair (see mssd_np)."""
    def proj(p):                                          # [..., N, 3]
        c = p @ K.T
        return c[..., :2] / c[..., 2:3]

    pe = proj(pts @ R_est.T + t_est)
    R_gt_s, t_gt_s = _np_gt_sym_poses(R_gt, t_gt, sym_rots, sym_trans)
    pg = proj(np.einsum("nj,sij->sni", pts, R_gt_s) + t_gt_s[:, None, :])
    d = np.linalg.norm(pe[None] - pg, axis=-1)
    return float(d.max(axis=1).min())
