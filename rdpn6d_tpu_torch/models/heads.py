"""Dense mask / coordinate / region head.

Counterpart of ``rdpn6d_tpu/models/heads.py:DenseHead`` (the reference's
``RotWithRegionHead``), NCHW. ``features`` keeps the reference's
``rot_head_net.features.*`` indices: 0 convT, 1 norm, 2 relu, then a
(conv3x3, norm, relu) triple per conv, then the 1x1 output conv. The
optional ``skip64`` (backbone.rot_concat) is concatenated after the
upsampling triple, and layers past the third upsample ×2 first. Under
int8 the 2·``num_layers`` body convs are ``Int8Conv`` (``models/quant.py``);
the 1×1 output conv stays in the model's dtype.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..ops.resize import upsample_bilinear_align_corners
from .norm import make_norm
from .quant import conv_factory


class DenseHead(nn.Module):
    def __init__(self, in_channels: int, mask_dim: int = 1,
                 coord_dim: int = 3, region_dim: int = 33,
                 num_filters: int = 256, num_layers: int = 3,
                 norm: str = "BN", gn_groups: int = 32,
                 skip_channels: int = 0, int8: bool = False,
                 int8_static: Any = False):
        super().__init__()
        self.mask_dim, self.coord_dim = mask_dim, coord_dim
        self.num_layers = num_layers
        # flax ConvTranspose(k3, s2, padding ((1,2),(1,2)),
        # transpose_kernel) is this exactly
        layers: list[nn.Module] = [
            nn.ConvTranspose2d(in_channels, num_filters, 3, stride=2,
                               padding=1, output_padding=1, bias=False),
            make_norm(norm, num_filters, gn_groups), nn.ReLU()]
        cin = num_filters + skip_channels
        conv = conv_factory(int8, int8_static)
        for _ in range(2 * num_layers):
            layers += [conv(cin, num_filters, 3, padding=1),
                       make_norm(norm, num_filters, gn_groups), nn.ReLU()]
            cin = num_filters
        layers.append(nn.Conv2d(num_filters,
                                mask_dim + coord_dim + region_dim, 1))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, skip64: torch.Tensor | None = None):
        """x [B, C, 32, 32] -> float32 (mask [B,Dm,64,64],
        coord [B,Dc,64,64], region [B,Dr,64,64])."""
        f = self.features
        x = f[2](f[1](f[0](x)))
        if skip64 is not None:
            x = torch.cat([x, skip64.to(x.dtype)], dim=1)
        for i in range(self.num_layers):
            if i >= 3:  # extra layers upsample further (reference :104)
                x = upsample_bilinear_align_corners(x, x.shape[2] * 2,
                                                    x.shape[3] * 2)
            for j in range(2):
                k = 3 + 3 * (2 * i + j)
                x = f[k + 2](f[k + 1](f[k](x)))
        out = f[-1](x).float()  # logits in float32
        md, cd = self.mask_dim, self.coord_dim
        return out[:, :md], out[:, md:md + cd], out[:, md + cd:]
