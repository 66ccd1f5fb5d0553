"""The reference's ROI crop: a frozen copy of the plain version in
``rdpn6d_tpu_torch/ops/roi_crop.py`` (the bilinear RGB and depth crops,
the normalisation, the back-projection and the coordinate map), with no
kernel.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from ..geometry.camera import backproject_depth
from .warp import crop_resize_frames


_AXES: dict[tuple[int, int, str], tuple[torch.Tensor, torch.Tensor]] = {}


def coord_axes(height: int, width: int, device: torch.device | str
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The axes of the full-frame [0, 1] coordinate map, (x [W], y [H]),
    as ``torch.linspace`` computes them on ``device`` (from both ends: not
    i / (n - 1)); built once per (height, width, device)."""
    key = (height, width, str(torch.device(device)))
    if key not in _AXES:
        _AXES[key] = (torch.linspace(0.0, 1.0, width, device=device),
                      torch.linspace(0.0, 1.0, height, device=device))
    return _AXES[key]


def crop_intrinsics(K: torch.Tensor, center: torch.Tensor,
                    scale: torch.Tensor, input_res: int) -> torch.Tensor:
    """K [B,3,3] composed with the crop's affine: rows 0 and 1 are
    r K[i] + t_i K[2], r = input_res / scale, t_i = input_res / 2 - r c_i,
    and row 2 is K[2]; ``geometry.camera.crop_K`` of ``ops/warp.crop_affine``
    without its exact zero terms, element-wise (no matrix product, whose
    order of sums differs between devices)."""
    r = input_res / scale
    t = input_res / 2.0 - r[:, None] * center
    top = r[:, None, None] * K[:, :2] + t[:, :, None] * K[:, 2:3]
    return torch.cat([top, K[:, 2:3]], dim=1)


def roi_crop_plain(rgb: torch.Tensor, depth: torch.Tensor,
                   depth_factor: torch.Tensor | None, K: torch.Tensor,
                   frame_idx: torch.Tensor, center: torch.Tensor,
                   scale: torch.Tensor, input_res: int, out_res: int,
                   mean: Sequence[float], std: Sequence[float],
                   normalize: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version (arguments as ``roi_crop``): the gather
    crops of the RGB, the depth and the coordinate map."""
    dev = rgb.device
    H, W = rgb.shape[1], rgb.shape[2]
    img = crop_resize_frames(rgb, frame_idx, center, scale, input_res)
    if normalize:
        img = (img - torch.tensor(mean, dtype=torch.float32, device=dev)) \
            / torch.tensor(std, dtype=torch.float32, device=dev)
    if depth_factor is not None:
        depth = depth.float() / depth_factor[:, None, None]
    d = crop_resize_frames(depth, frame_idx, center, scale, input_res)
    Kc = crop_intrinsics(K[frame_idx], center, scale, input_res)
    resize_ratio = out_res / scale
    xyz = backproject_depth(d / resize_ratio[:, None, None], Kc)
    roi_img = torch.cat([img, xyz], dim=-1)                 # [B, S, S, 6]
    lx, ly = coord_axes(H, W, dev)
    yy, xx = torch.meshgrid(ly, lx, indexing="ij")
    coord2d = crop_resize_frames(torch.stack([xx, yy], dim=-1)[None],
                                 torch.zeros_like(frame_idx), center, scale,
                                 out_res)
    stride = input_res // out_res
    roi_coord_2d = torch.cat([xyz[:, ::stride, ::stride], coord2d], dim=-1)
    return roi_img, roi_coord_2d                            # [B, O, O, 5]


roi_crop = roi_crop_plain
