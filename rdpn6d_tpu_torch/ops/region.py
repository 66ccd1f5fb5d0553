"""Model-side region gather.

Counterpart of ``rdpn6d_tpu/ops/region.py:gather_region_fps``. The label
side (``xyz_to_region``, ``residual_coord_target``) belongs to training and
is not ported yet.
"""

from __future__ import annotations

import torch


def gather_region_fps(fps_points: torch.Tensor,
                      region_ids: torch.Tensor) -> torch.Tensor:
    """Per-pixel FPS keypoint for predicted region ids.

    fps_points [B, K, 3]; region_ids [B, H, W] in 0..K-1 (background
    channel already dropped) -> [B, H, W, 3]."""
    B, H, W = region_ids.shape
    flat = region_ids.reshape(B, H * W, 1).expand(B, H * W, 3)
    return torch.gather(fps_points, 1, flat).reshape(B, H, W, 3)
