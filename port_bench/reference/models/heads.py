"""Dense mask / coordinate / region head.

Counterpart of ``rdpn6d_tpu/models/heads.py:DenseHead`` (the reference's
``RotWithRegionHead``), NCHW. ``features`` keeps the reference's
``rot_head_net.features.*`` indices: 0 convT, 1 norm, 2 relu, then a
(conv3x3, norm, relu) triple per conv, then the 1x1 output conv. The
optional ``skip64`` (backbone.rot_concat) is concatenated after the
upsampling triple, and layers past the third upsample ×2 first. Under
int8 the 2·``num_layers`` body convs are ``Int8Conv`` (``models/quant.py``);
the 1×1 output conv stays in the model's dtype. With BatchNorm, each int8
conv takes the (BN, ReLU) before it folded into its quantizer, and the
first also the concat of ``skip64`` (one ``bn_relu_quantize`` pass where a
BN, a ReLU, a concat and a quantize ran): the conv is given the BN's
input. The last BN and ReLU, before the output conv, and a conv behind an
upsample (layers past the third) stay unfused.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..ops.resize import upsample_bilinear_align_corners
from .norm import BatchNorm2d, make_norm
from .quant import Int8Conv, conv_factory


class DenseHead(nn.Module):
    def __init__(self, in_channels: int, mask_dim: int = 1,
                 coord_dim: int = 3, region_dim: int = 33,
                 num_filters: int = 256, num_layers: int = 3,
                 norm: str = "BN", gn_groups: int = 32,
                 skip_channels: int = 0, int8: bool = False,
                 bits: int = 8):
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
        conv = conv_factory(int8, bits)
        for _ in range(2 * num_layers):
            layers += [conv(cin, num_filters, 3, padding=1),
                       make_norm(norm, num_filters, gn_groups), nn.ReLU()]
            cin = num_filters
        layers.append(nn.Conv2d(num_filters,
                                mask_dim + coord_dim + region_dim, 1))
        self.features = nn.Sequential(*layers)

    def _conv(self, k: int, y: torch.Tensor, i: int, j: int,
              skip64: torch.Tensor | None) -> torch.Tensor:
        """Body conv ``features[k]`` (layer i, conv j) on ``y``, the output
        of the conv before it (for the first, of the convT): with the (BN,
        ReLU) between them (and, at the first, the concat of ``skip64``)
        folded into its quantizer where it can be, else run first."""
        f = self.features
        bn, relu, conv = f[k - 2], f[k - 1], f[k]
        first = i == 0 and j == 0
        if isinstance(conv, Int8Conv) \
                and isinstance(bn, BatchNorm2d) and not bn.training \
                and not (i >= 3 and j == 0):
            return conv(y, bn, skip64 if first else None)
        x = relu(bn(y))
        if first and skip64 is not None:
            x = torch.cat([x, skip64.to(x.dtype)], dim=1)
        if i >= 3 and j == 0:  # extra layers upsample further (reference :104)
            x = upsample_bilinear_align_corners(x, x.shape[2] * 2,
                                                x.shape[3] * 2)
        return conv(x)

    def forward(self, x: torch.Tensor, skip64: torch.Tensor | None = None):
        """x [B, C, 32, 32] -> float32 (mask [B,Dm,64,64],
        coord [B,Dc,64,64], region [B,Dr,64,64])."""
        f = self.features
        y = f[0](x)
        for i in range(self.num_layers):
            for j in range(2):
                y = self._conv(3 + 3 * (2 * i + j), y, i, j, skip64)
        x = f[-2](f[-3](y))
        out = f[-1](x).float()  # logits in float32
        md, cd = self.mask_dim, self.coord_dim
        return out[:, :md], out[:, md:md + cd], out[:, md + cd:]


class TransHead(nn.Module):
    """Direct-translation head (``pnp.r_only``): counterpart of
    ``rdpn6d_tpu/models/heads.py:TransHead``, the reference's
    ``TransHeadNet`` with its names, ``features`` = (conv3x3 without bias,
    norm, relu) triples and ``linears`` = Linear, ReLU, Linear, ReLU,
    Linear. It reads the trunk's final feature map [B, C, 8, 8], flattened
    NCHW, and returns float32 (centroid_rel, z_rel) [B, 3]."""

    def __init__(self, in_channels: int, num_filters: int = 256,
                 num_layers: int = 3, norm: str = "BN", gn_groups: int = 32,
                 in_res: int = 8):
        super().__init__()
        layers: list[nn.Module] = []
        cin = in_channels
        for _ in range(num_layers):
            layers += [nn.Conv2d(cin, num_filters, 3, padding=1, bias=False),
                       make_norm(norm, num_filters, gn_groups), nn.ReLU()]
            cin = num_filters
        self.features = nn.Sequential(*layers)
        self.linears = nn.Sequential(
            nn.Linear(num_filters * in_res * in_res, 4096), nn.ReLU(),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Linear(4096, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x.to(self.linears[0].weight.dtype))
        return self.linears(x.flatten(1)).float()
