"""PointNet-style Patch-PnP heads: the dense correspondence map as a point
set, shared pointwise MLPs, a global pool, then fully connected layers to
(rot, t).

Counterpart of ``rdpn6d_tpu/models/point_pnp.py`` (``_denorm_bare_coords``,
``SimplePointPnP``, ``PointPnP``), ``pnp.pnp_head`` "SimplePointPnP" or
"PointPnP". The JAX package's layers have no reference checkpoint, so the
names are the port's own: ``mlp.{0,1,2}`` (the pointwise layers), ``fc1``,
``fc2``, ``fc_r``, ``fc_t`` (flax's ``Dense_0`` .. ``Dense_6``). Inputs are
NCHW [B, C, H, W]; the points are the pixels in row-major order, as the
JAX package flattens NHWC. The layers run in the parameters' dtype, the
outputs are float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _denorm_bare_coords(x: torch.Tensor,
                        extents: torch.Tensor | None) -> torch.Tensor:
    """A bare 3- or 5-channel assembly has its xyz rescaled to metres by
    the class extents; richer ones stay normalised."""
    if x.shape[1] in (3, 5) and extents is not None:
        xyz = (x[:, :3] - 0.5) * extents[:, :, None, None]
        x = torch.cat([xyz, x[:, 3:]], dim=1)
    return x


class _PointMLP(nn.Module):
    def __init__(self, in_channels: int, featdim: int, hidden: tuple,
                 pooled: int, rot_dim: int):
        super().__init__()
        widths = (in_channels, 64, 128, featdim)
        self.mlp = nn.ModuleList(nn.Linear(a, b)
                                 for a, b in zip(widths, widths[1:]))
        self.fc1 = nn.Linear(pooled, hidden[0])
        self.fc2 = nn.Linear(hidden[0], hidden[1])
        self.fc_r = nn.Linear(hidden[1], rot_dim)
        self.fc_t = nn.Linear(hidden[1], 3)

    def points(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] -> pointwise features [B, H*W, featdim]."""
        pts = x.to(self.fc1.weight.dtype).flatten(2).transpose(1, 2)
        for layer in self.mlp:
            pts = torch.relu(layer(pts))
        return pts

    def head(self, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h = F.leaky_relu(self.fc1(g), 0.1)
        h = F.leaky_relu(self.fc2(h), 0.1)
        return self.fc_r(h).float(), self.fc_t(h).float()


class SimplePointPnP(_PointMLP):
    """Pointwise MLP + global max pool -> FC -> (rot, t). ``in_channels``
    counts the region softmax where it is concatenated."""

    def __init__(self, in_channels: int, rot_dim: int = 6,
                 featdim: int = 256):
        super().__init__(in_channels, featdim, (256, 128), featdim, rot_dim)

    def forward(self, coord_feat: torch.Tensor,
                region: torch.Tensor | None = None,
                extents: torch.Tensor | None = None,
                mask_attention: torch.Tensor | None = None):
        x = _denorm_bare_coords(coord_feat, extents)
        if region is not None:
            x = torch.cat([x, region], dim=1)
        if mask_attention is not None:
            x = x * mask_attention
        return self.head(self.points(x).amax(dim=1))


class PointPnP(_PointMLP):
    """Region-pooled variant: each region's softmax, normalised over the
    points, weights a sum of the point features ([B, K, F], flattened)."""

    def __init__(self, in_channels: int, rot_dim: int = 6,
                 featdim: int = 128, num_regions: int = 32):
        super().__init__(in_channels, featdim, (512, 256),
                         num_regions * featdim, rot_dim)
        self.num_regions = num_regions

    def forward(self, coord_feat: torch.Tensor,
                region: torch.Tensor | None = None,
                extents: torch.Tensor | None = None,
                mask_attention: torch.Tensor | None = None):
        if region is None or region.shape[1] != self.num_regions:
            raise ValueError(
                f"PointPnP needs the {self.num_regions}-region softmax "
                "(pnp.region_attention)")
        x = _denorm_bare_coords(coord_feat, extents)
        if mask_attention is not None:
            x = x * mask_attention
        pts = self.points(x)
        w = region.flatten(2)                            # [B, K, HW]
        w = w / (w.sum(dim=2, keepdim=True) + 1e-6)
        pooled = torch.bmm(w.to(pts.dtype), pts)         # [B, K, F]
        return self.head(pooled.flatten(1))
