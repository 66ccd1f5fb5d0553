"""Patch-PnP: a small CNN regressing rotation and centroid/z from the dense
correspondence features.

Counterpart of ``rdpn6d_tpu/models/conv_pnp.py`` (``dropblock``,
``ConvPnPNet``), NCHW, with the reference's ``pnp_net.*`` names:
``features`` = (conv3x3, norm, relu) triples, then ``fc1``, ``fc2``,
``fc_r``, ``fc_t``. ``fc1`` reads the feature map flattened NCHW, as the
reference does. In train mode with ``drop_prob > 0`` DropBlock masks the
input map first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .norm import make_norm


def dropblock(x: torch.Tensor, drop_prob: float, block_size: int = 5,
              generator: torch.Generator | None = None,
              seeds: torch.Tensor | None = None,
              shard: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """DropBlock on x [B, C, H, W]: zero block_size² patches around seed
    pixels drawn with rate gamma = drop_prob / block_size² (the vendored
    variant: no edge correction), then rescale by the keep rate taken over
    the WHOLE batch. ``seeds`` [B, 1, H, W] (0/1) replaces the draw from
    ``generator``. ``shard`` (rank, world): x is that rank's equal shard
    of a global batch; the draw and the keep rate are the global batch's,
    and the rank keeps its rows."""
    B, _, H, W = x.shape
    r, n = shard
    if seeds is None:
        gamma = drop_prob / block_size ** 2
        u = torch.rand((B * n, 1, H, W), generator=generator,
                       device=x.device)
        seeds = (u < gamma).to(x.dtype)
    block = F.max_pool2d(seeds.to(x.dtype), block_size, stride=1,
                         padding=block_size // 2)
    mask = 1.0 - block
    keep = mask.mean()                      # batch-global keep rate
    return x * mask[r * B:(r + 1) * B] / keep.clamp_min(1e-6)


class ConvPnPNet(nn.Module):
    def __init__(self, in_channels: int, rot_dim: int = 6,
                 featdim: int = 128, num_layers: int = 3,
                 gn_groups: int = 32, norm: str = "GN",
                 in_res: int = 64, drop_prob: float = 0.0,
                 drop_block_size: int = 5):
        super().__init__()
        self.drop_prob, self.drop_block_size = drop_prob, drop_block_size
        layers: list[nn.Module] = []
        res, cin = in_res, in_channels
        for i in range(num_layers):
            stride = 2 if i < 3 else 1   # 64 -> 8 over the first three
            layers += [nn.Conv2d(cin, featdim, 3, stride, 1, bias=False),
                       make_norm(norm, featdim, gn_groups), nn.ReLU()]
            res = (res - 1) // stride + 1
            cin = featdim
        self.features = nn.Sequential(*layers)
        self.fc1 = nn.Linear(featdim * res * res, 1024)
        self.fc2 = nn.Linear(1024, 256)
        self.fc_r = nn.Linear(256, rot_dim)
        self.fc_t = nn.Linear(256, 3)

    def forward(self, coord_feat: torch.Tensor,
                region: torch.Tensor | None = None,
                extents: torch.Tensor | None = None,
                mask_attention: torch.Tensor | None = None,
                mask_concat: torch.Tensor | None = None,
                drop_scale: float = 1.0,
                generator: torch.Generator | None = None,
                drop_shard: tuple[int, int] = (0, 1)):
        """coord_feat [B, C, 64, 64]; region [B, K, 64, 64] softmax;
        extents [B, 3]; mask_attention / mask_concat [B, 1, 64, 64];
        drop_scale ramps DropBlock's rate, whose draw comes from
        ``generator``, over the global batch of ``drop_shard``. Returns
        float32 (rot_param [B, rot_dim], trans_param [B, 3])."""
        x = coord_feat
        # the reference denormalizes only bare coordinate assemblies
        # (3, 5, 6 or 8 channels, judged before region/mask concat)
        if x.shape[1] in (3, 5, 6, 8):
            if extents is None:
                raise ValueError("ConvPnPNet: extents required to "
                                 "denormalize coordinates")
            xyz = (x[:, :3] - 0.5) * extents[:, :, None, None]
            x = torch.cat([xyz, x[:, 3:]], dim=1)
        if region is not None:
            x = torch.cat([x, region], dim=1)
        if mask_attention is not None:
            x = x * mask_attention
        if mask_concat is not None:
            x = torch.cat([x, mask_concat], dim=1)
        if self.training and self.drop_prob > 0:
            x = dropblock(x, self.drop_prob * drop_scale,
                          self.drop_block_size, generator,
                          shard=drop_shard)
        x = self.features(x.to(self.fc1.weight.dtype))
        x = x.flatten(1)
        x = F.leaky_relu(self.fc1(x), 0.1)
        x = F.leaky_relu(self.fc2(x), 0.1)
        return self.fc_r(x).float(), self.fc_t(x).float()
