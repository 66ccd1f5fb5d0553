"""Region ids and residual coordinates of the reference: a frozen copy of
the plain parts of ``rdpn6d_tpu_torch/ops/region.py``.
"""

from __future__ import annotations


import torch


def _foreground(xyz: torch.Tensor) -> torch.Tensor:
    return (xyz[..., 0] != 0) | (xyz[..., 1] != 0) | (xyz[..., 2] != 0)


def _nearest_plain(xyz: torch.Tensor, fps: torch.Tensor) -> torch.Tensor:
    """Index of the nearest keypoint, [B,H,W] int64: the direct form,
    summed x, y, z in that order, first minimum on ties."""
    f = fps[:, None, None]                           # [B,1,1,K,3]
    x = xyz[..., None, :]                            # [B,H,W,1,3]
    d2 = (x[..., 0] - f[..., 0]) ** 2 + (x[..., 1] - f[..., 1]) ** 2 \
        + (x[..., 2] - f[..., 2]) ** 2               # [B,H,W,K]
    return d2.argmin(dim=-1)


def _gather_fps(fps: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """fps [B,K,3] indexed by idx [B,H,W] -> [B,H,W,3]."""
    B, H, W = idx.shape
    flat = idx.reshape(B, H * W, 1).expand(B, H * W, 3)
    return torch.gather(fps, 1, flat).reshape(B, H, W, 3)


def region_label_plain(xyz: torch.Tensor, fps: torch.Tensor,
                       rot: torch.Tensor, extent: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version. xyz [B,H,W,3], fps [B,K,3], rot
    [B,3,3], extent [B,3], float32 -> (region [B,H,W] int32,
    coord [B,H,W,3] float32)."""
    nearest = _nearest_plain(xyz, fps)
    region = torch.where(_foreground(xyz), nearest.to(torch.int32) + 1,
                         torch.zeros((), dtype=torch.int32,
                                     device=xyz.device))
    delta = xyz - _gather_fps(fps, nearest)
    rotated = torch.einsum("bij,bhwj->bhwi", rot, delta)
    return region, rotated / extent[:, None, None, :] + 0.5


def residual_coord_target(xyz: torch.Tensor, fps_points: torch.Tensor,
                          rot_gt: torch.Tensor, extent: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The RDPN coordinate target: xyz [B,H,W,3], fps [B,K,3], rot_gt
    [B,3,3], extent [B,3] -> (region [B,H,W] int32 in 0..K,
    coord [B,H,W,3] = R_gt (xyz - fps[region]) / extent + 0.5)."""
    return region_label(xyz, fps_points, rot_gt, extent)


def xyz_to_region(xyz: torch.Tensor, fps_points: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-keypoint region id and raw residual: xyz [B,H,W,3],
    fps [B,K,3] -> (region [B,H,W] int32 in 0..K, 0 = background,
    delta [B,H,W,3] = xyz - fps[nearest])."""
    B = xyz.shape[0]
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device).expand(B, 3, 3)
    region, _ = region_label(xyz, fps_points, eye.contiguous(),
                             torch.ones(B, 3, dtype=xyz.dtype,
                                        device=xyz.device))
    # a background pixel's nearest keypoint is the one nearest the origin
    origin = (fps_points * fps_points).sum(-1).argmin(-1)       # [B]
    nearest = torch.where(region > 0, region.long() - 1,
                          origin[:, None, None])
    return region, xyz - _gather_fps(fps_points, nearest)


def gather_region_fps(fps_points: torch.Tensor,
                      region_ids: torch.Tensor) -> torch.Tensor:
    """Per-pixel FPS keypoint for predicted region ids.

    fps_points [B, K, 3]; region_ids [B, H, W] in 0..K-1 (background
    channel already dropped) -> [B, H, W, 3]."""
    return _gather_fps(fps_points, region_ids)


region_label = region_label_plain
