"""The reference's GT labels from shipped xyz maps: a frozen copy of the
plain version in ``rdpn6d_tpu_torch/ops/gt_labels.py``, with no kernel.
"""

from __future__ import annotations


import torch

from .region import region_label_plain
from .warp import crop_resize_frames


Labels = dict[str, torch.Tensor]


def gt_labels_plain(mask: torch.Tensor, trunc: torch.Tensor | None,
                    xyz: torch.Tensor, center: torch.Tensor,
                    scale: torch.Tensor, fps: torch.Tensor,
                    rot: torch.Tensor, extent: torch.Tensor, out_res: int,
                    residual: bool = True) -> Labels:
    """The plain PyTorch version (arguments as ``gt_labels``): one stacked
    float32 nearest crop of the masks and the xyz map, then the labels."""
    if mask.dtype == torch.uint8:
        visib_in = (mask & 1).float()
        trunc_in = ((mask >> 1) & 1).float()
    else:
        visib_in, trunc_in = mask, trunc
    xyz_full = xyz.float()
    mask_obj = (xyz_full != 0).any(dim=-1).float()
    planes = [(visib_in * mask_obj)[..., None], mask_obj[..., None], xyz_full]
    if trunc_in is not None:
        planes.append((trunc_in * mask_obj)[..., None])
    own = torch.arange(xyz.shape[0], device=xyz.device)
    stacked = crop_resize_frames(torch.cat(planes, dim=-1), own, center,
                                 scale, out_res, interp="nearest")
    roi_xyz = stacked[..., 2:5].contiguous()
    region, coord = region_label_plain(roi_xyz, fps, rot, extent)
    if not residual:
        coord = roi_xyz / extent[:, None, None, :] + 0.5
    visib = stacked[..., 0]
    return {"roi_mask_visib": visib, "roi_mask_obj": stacked[..., 1],
            "roi_mask_trunc": stacked[..., 5] if trunc_in is not None
            else visib, "roi_region": region, "roi_xyz": coord}


gt_labels = gt_labels_plain
