"""PointNet-style spatial fusion of CNN features with depth-XYZ.

Counterpart of ``rdpn6d_tpu/models/pointnet.py:SpatialPointNet`` (the
reference's ``md_pointnet``), NCHW, with the reference's module names
(``xyz_emb``/``xb``, ``conv1..3``/``b1..3``): embed the feature map with a
1x1 conv, concatenate the per-pixel XYZ, run a pointwise MLP, and append
the global max-pooled feature broadcast over the grid.
"""

from __future__ import annotations

import torch
from torch import nn

from .norm import BatchNorm2d


class SpatialPointNet(nn.Module):
    widths = (64, 128, 256, 512)

    def __init__(self, in_channels: int):
        super().__init__()
        widths = self.widths
        self.out_channels = 2 * widths[3]
        self.xyz_emb = nn.Conv2d(in_channels, widths[0], 1)
        self.xb = BatchNorm2d(widths[0])
        self.conv1 = nn.Conv2d(3 + widths[0], widths[1], 1)
        self.b1 = BatchNorm2d(widths[1])
        self.conv2 = nn.Conv2d(widths[1], widths[2], 1)
        self.b2 = BatchNorm2d(widths[2])
        self.conv3 = nn.Conv2d(widths[2], widths[3], 1)
        self.b3 = BatchNorm2d(widths[3])

    def forward(self, feat: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        """feat [B, C, H, W]; xyz [B, 3, H, W] -> [B, 1024, H, W]."""
        emb = torch.relu(self.xb(self.xyz_emb(feat)))
        h = torch.cat([xyz.to(emb.dtype), emb], dim=1)
        h = torch.relu(self.b1(self.conv1(h)))
        h = torch.relu(self.b2(self.conv2(h)))
        local = self.b3(self.conv3(h))
        glob = local.amax(dim=(2, 3), keepdim=True).expand_as(local)
        return torch.cat([local, glob], dim=1)
