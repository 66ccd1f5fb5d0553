"""BOP19 challenge errors: MSSD and MSPD, batched on torch tensors and on
host numpy for one (estimate, GT) pair, and VSD on host depth renders.

Counterpart of ``rdpn6d_tpu/evaluation/bop_errors.py``: the batched
versions reduce min over the identity-padded symmetry banks of the max
over model points; the numpy versions are what the BOP19 scorer calls per
pair. ``vsd`` renders both poses with the port's host rasterizer
(``ops/rasterizer.py``) and scores them with ``vsd_from_depths``, numpy
as in the JAX package.
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


def vsd(R_est: np.ndarray, t_est: np.ndarray, R_gt: np.ndarray,
        t_gt: np.ndarray, depth_test: np.ndarray, K: np.ndarray,
        verts: np.ndarray, faces: np.ndarray,
        delta: float = 15.0 / 1000.0, taus=(0.05,),
        diameter: float | None = None,
        normalized_by_diameter: bool = True,
        cost_type: str = "step") -> list[float]:
    """Visible surface discrepancy (the BOP toolkit's vsd, BOP19 defaults).

    depth_test: [H, W] scene depth (m). Returns one error per tau; taus are
    fractions of the diameter when normalized_by_diameter else metres.
    """
    from ..ops.rasterizer import render_mesh

    H, W = depth_test.shape
    d_est, _ = render_mesh(verts, faces, K, R_est, t_est, H, W)
    d_gt, _ = render_mesh(verts, faces, K, R_gt, t_gt, H, W)
    return vsd_from_depths(d_est, d_gt, depth_test, delta=delta, taus=taus,
                           diameter=diameter,
                           normalized_by_diameter=normalized_by_diameter,
                           cost_type=cost_type)


def vsd_from_depths(d_est: np.ndarray, d_gt: np.ndarray,
                    depth_test: np.ndarray,
                    delta: float = 15.0 / 1000.0, taus=(0.05,),
                    diameter: float | None = None,
                    normalized_by_diameter: bool = True,
                    cost_type: str = "step") -> list[float]:
    """VSD from depth maps rendered beforehand: a scorer renders the GT
    pose once for every estimate of its target (``bop_score.
    make_vsd_error_fn``)."""
    # visibility masks, the toolkit's 'bop19' mode: visible where the
    # rendered surface is within delta of (or in front of) the measured
    # scene depth, or where the scene depth is missing (surfaces the
    # sensor cannot capture); the estimate's visibility also takes the
    # pixels visible in the GT's
    valid_scene = depth_test > 0

    def visib(d):
        m = d > 0
        # the toolkit's <= delta: a pixel exactly at delta is visible
        below = m & valid_scene & (d - depth_test <= delta)
        only_render = m & ~valid_scene
        return below | only_render

    v_gt = visib(d_gt)
    v_est = visib(d_est) | ((d_est > 0) & v_gt)

    inter = v_gt & v_est
    union = v_gt | v_est
    n_union = int(union.sum())
    if n_union == 0:
        return [1.0] * len(taus)
    # the tau-invariant parts once (BOP19 sweeps 10 taus)
    diff = np.abs(d_est[inter] - d_gt[inter])
    n_outer = float((~inter & union).sum())
    errs = []
    for tau in taus:
        tau_abs = tau * diameter if (normalized_by_diameter
                                     and diameter is not None) else tau
        if cost_type == "step":
            cost_sum = float((diff > tau_abs).sum())
        else:  # tlinear
            cost_sum = float(np.clip(diff / tau_abs, 0, 1).sum())
        errs.append((cost_sum + n_outer) / n_union)
    return errs
