"""The reference's labels from the depth surface: a frozen copy of the
plain version in ``rdpn6d_tpu_torch/ops/surface_labels.py``, with no
kernel.
"""

from __future__ import annotations


import torch

from .region import _foreground, _gather_fps, _nearest_plain
from .warp import crop_resize_frames


Labels = dict[str, torch.Tensor]


def surface_labels_plain(depth: torch.Tensor, frame_idx: torch.Tensor,
                         mask: torch.Tensor, trunc: torch.Tensor | None,
                         cam: torch.Tensor, center: torch.Tensor,
                         scale: torch.Tensor, fps: torch.Tensor,
                         rot: torch.Tensor, trans: torch.Tensor,
                         extent: torch.Tensor, out_res: int,
                         residual: bool = True) -> Labels:
    """The plain PyTorch version (arguments as ``surface_labels``): nearest
    crops of the (u, v) grid, the depth and the stacked float32 masks,
    then the back-projection and the labels."""
    if mask.dtype == torch.uint8:
        visib_in = (mask & 1).float()
        trunc_in = ((mask >> 1) & 1).float()
    else:
        visib_in, trunc_in = mask, trunc
    H, W = depth.shape[1], depth.shape[2]
    dev = depth.device

    def nearest(planes, idx):
        return crop_resize_frames(planes, idx, center, scale, out_res,
                                  interp="nearest")

    # the nearest crop picks one source pixel (u, v) per output pixel
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    uv = nearest(torch.stack([u, v], dim=-1)[None],
                 torch.zeros_like(frame_idx))
    depth_c = nearest(depth, frame_idx)
    masks = [visib_in] + ([trunc_in] if trunc_in is not None else [])
    mask_c = nearest(torch.stack(masks, dim=-1),
                     torch.arange(mask.shape[0], device=dev))
    m = (depth_c > 1e-6).float() * mask_c[..., 0]
    fx, fy = cam[:, 0, 0, None, None], cam[:, 1, 1, None, None]
    px, py = cam[:, 0, 2, None, None], cam[:, 1, 2, None, None]
    a = torch.stack([(uv[..., 0] - px) * depth_c / fx,
                     (uv[..., 1] - py) * depth_c / fy, depth_c], dim=-1) \
        - trans[:, None, None, :]
    r = rot[:, None, None]                          # [B,1,1,3,3]
    # xyz = R^T (p - t), the sums in the kernel's order
    xyz = ((a[..., 0:1] * r[..., 0, :] + a[..., 1:2] * r[..., 1, :])
           + a[..., 2:3] * r[..., 2, :]) * m[..., None]
    nearest_k = _nearest_plain(xyz, fps)
    region = torch.where(_foreground(xyz), nearest_k.to(torch.int32) + 1,
                         torch.zeros((), dtype=torch.int32, device=dev))
    if residual:
        delta = xyz - _gather_fps(fps, nearest_k)
        coord = ((delta[..., 0:1] * r[..., :, 0]
                  + delta[..., 1:2] * r[..., :, 1])
                 + delta[..., 2:3] * r[..., :, 2])
    else:
        coord = xyz
    coord = coord / extent[:, None, None, :] + 0.5
    return {"roi_mask_visib": m, "roi_mask_obj": m,
            "roi_mask_trunc": mask_c[..., 1] * m if trunc_in is not None
            else m, "roi_region": region, "roi_xyz": coord}


surface_labels = surface_labels_plain
