"""Pinhole camera math: projection, back-projection, crop-adjusted
intrinsics, and centroid/z pose recovery.

Counterpart of ``rdpn6d_tpu/geometry/camera.py``; batched over leading
dims, everything in the caller's dtype (the pipeline and the pose recovery
call it in float32).
"""

from __future__ import annotations

import torch

from .allocentric import allo_to_ego_mat


def transform_pts(points: torch.Tensor, R: torch.Tensor,
                  t: torch.Tensor | None = None) -> torch.Tensor:
    """points [..., N, 3] @ R^T (+ t). R [..., 3, 3], t [..., 3] or None."""
    out = points @ R.transpose(-1, -2)
    if t is not None:
        out = out + t[..., None, :]
    return out


def project(points: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
            t: torch.Tensor) -> torch.Tensor:
    """Project model points to pixels. points [..., N, 3], K/R [..., 3, 3],
    t [..., 3] -> [..., N, 2]."""
    pc = transform_pts(points, R, t)
    uvw = pc @ K.transpose(-1, -2)
    return uvw[..., :2] / uvw[..., 2:3].clamp_min(1e-9)


def backproject_depth(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Per-pixel camera-frame XYZ from a depth map: depth [..., H, W],
    K [..., 3, 3] -> [..., H, W, 3]. Pixel centers at integer coordinates
    (cv2 convention)."""
    H, W = depth.shape[-2], depth.shape[-1]
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")  # [H, W]
    fx = K[..., 0, 0][..., None, None]
    fy = K[..., 1, 1][..., None, None]
    cx = K[..., 0, 2][..., None, None]
    cy = K[..., 1, 2][..., None, None]
    x = (uu - cx) * depth / fx
    y = (vv - cy) * depth / fy
    return torch.stack([x, y, depth], dim=-1)


def crop_K(K: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """Compose a 2x3 image affine with intrinsics: K' = [[A];[0 0 1]] @ K."""
    bottom = torch.tensor([0.0, 0.0, 1.0], dtype=K.dtype,
                          device=K.device).expand(affine.shape[:-2] + (1, 3))
    A3 = torch.cat([affine, bottom], dim=-2)
    return A3 @ K


def recover_pose_centroid_z(
    rot_allo: torch.Tensor,
    centroid_rel: torch.Tensor,
    z_rel: torch.Tensor,
    K: torch.Tensor,
    bbox_center: torch.Tensor,
    bbox_wh: torch.Tensor,
    resize_ratio: torch.Tensor,
    z_type: str = "REL",
    is_allo: bool = True,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Egocentric (R, t) from the regressed allocentric rotation, the
    box-relative centroid offset and z:
        tx = (cx - px) * tz / fx,  ty = (cy - py) * tz / fy,  tz = z."""
    c_abs = centroid_rel * bbox_wh + bbox_center  # [..., 2]
    if z_type == "REL":
        z = z_rel * resize_ratio
    elif z_type == "ABS":
        z = z_rel
    elif z_type == "LOG":
        z = torch.exp(z_rel)
    elif z_type == "NEG_LOG":
        z = torch.exp(-z_rel)
    else:
        raise ValueError(f"unknown z_type: {z_type}")
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    px, py = K[..., 0, 2], K[..., 1, 2]
    tx = z * (c_abs[..., 0] - px) / fx
    ty = z * (c_abs[..., 1] - py) / fy
    trans = torch.stack([tx, ty, z], dim=-1)
    rot_ego = allo_to_ego_mat(trans, rot_allo, eps=eps) if is_allo \
        else rot_allo
    return rot_ego, trans
