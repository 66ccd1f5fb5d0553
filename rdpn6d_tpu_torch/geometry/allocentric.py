"""Allocentric <-> egocentric rotation conversion.

Counterpart of ``rdpn6d_tpu/geometry/allocentric.py``: the correction
rotates the optical axis (0,0,1) onto the ray to the object centroid, in
the exact branchless Rodrigues form R = I + [u]x + [u]x^2 / (1 + c) with
u = (0,0,1) x ray and c = ray_z. No arccos, so it stays exact when the
object sits on the optical axis.
"""

from __future__ import annotations

import torch

from .rotations import normalize


def _rotation_cam_to_obj(translation: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    v = normalize(translation, eps=eps)
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(vx)
    K = torch.stack([zero, zero, vx,
                     zero, zero, vy,
                     -vx, -vy, zero], dim=-1).reshape(vx.shape + (3, 3))
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    return eye + K + (K @ K) / (1.0 + vz + eps)[..., None, None]


def allo_to_ego_mat(translation: torch.Tensor, rot_allo: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """R_ego = R_corr(t) @ R_allo. translation [..., 3], rot [..., 3, 3]
    (the product in the wider of the two dtypes)."""
    corr = _rotation_cam_to_obj(translation, eps)
    dt = torch.promote_types(corr.dtype, rot_allo.dtype)
    return corr.to(dt) @ rot_allo.to(dt)


def ego_to_allo_mat(translation: torch.Tensor, rot_ego: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """R_allo = R_corr(t)^T @ R_ego, the inverse correction."""
    return _rotation_cam_to_obj(translation, eps).transpose(-1, -2) @ rot_ego
