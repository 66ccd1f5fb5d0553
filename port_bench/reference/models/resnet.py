"""ResNet trunk, NCHW, with torchvision's module names.

Counterpart of ``rdpn6d_tpu/models/resnet.py`` (``BasicBlock``,
``Bottleneck``, ``ResNetTrunk``). Names follow torchvision
(``conv1``/``bn1``/``layerN.i.{conv,bn}k``/``downsample``), which is the
reference checkpoint's ``backbone.*`` layout. Under int8 the blocks' convs
of the quantized stages, the 1×1 downsample included, are ``Int8Conv``
(``models/quant.py``); the stem stays in the model's dtype. With
``s2d_stem`` (``backbone.space_to_depth``) the 7×7/s2 stem is the exactly
equivalent space-to-depth(2) + 4×4/s1 conv with padding (2, 1): ``conv1``
is then [64, 12, 4, 4], and ``stem_kernel_to_s2d`` remaps a 7×7 kernel
(a torchvision trunk's) to it.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm2d
from .quant import conv_factory

RESNET_SPECS: dict[int, tuple[str, tuple[int, ...]]] = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c)  # flax momentum 0.9, eps 1e-5


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 int8: bool = False, int8_static: Any = False):
        super().__init__()
        conv = conv_factory(False)
        self.conv1 = conv(cin, planes, 3, stride, 1)
        self.bn1 = _bn(planes)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.bn2 = _bn(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(conv(cin, planes, 1, stride),
                                            _bn(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        idt = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + idt)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 int8: bool = False, int8_static: Any = False):
        super().__init__()
        out = planes * 4
        conv = conv_factory(False)
        self.conv1 = conv(cin, planes, 1)
        self.bn1 = _bn(planes)
        self.conv2 = conv(planes, planes, 3, stride, 1)
        self.bn2 = _bn(planes)
        self.conv3 = conv(planes, out, 1)
        self.bn3 = _bn(out)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(conv(cin, out, 1, stride),
                                            _bn(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idt = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + idt)


def stem_kernel_to_s2d(k7: torch.Tensor) -> torch.Tensor:
    """Remap a [O, C, 7, 7] stride-2 stem kernel to the exactly equivalent
    [O, 4C, 4, 4] space-to-depth(2) stride-1 kernel: tap a = 2 k + d - 1
    (k < 4, d < 2) of channel block 2 d_i + d_j; taps outside 0..6 are the
    structural zeros of the 8-wide cover."""
    O, C = k7.shape[:2]
    k4 = k7.new_zeros((O, 4 * C, 4, 4))
    for ku in range(4):
        for kv in range(4):
            for di in range(2):
                for dj in range(2):
                    au, av = 2 * ku + di - 1, 2 * kv + dj - 1
                    if 0 <= au < 7 and 0 <= av < 7:
                        blk = (di * 2 + dj) * C
                        k4[:, blk:blk + C, ku, kv] = k7[:, :, au, av]
    return k4


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[B, C, H, W] -> [B, b²C, H/b, W/b]; channel (d_i b + d_j) C + c, the
    JAX package's order."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // block, block, W // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(
        B, block * block * C, H // block, W // block)


class ResNetTrunk(nn.Module):
    """conv7x7/2 (or its space-to-depth form) + maxpool/2 + 4 stages: 256²
    RGB -> 8x8 final feature. ``int8_stages``: which of the 4 stages run
    their convs in int8 (None: none)."""

    def __init__(self, depth: int = 34,
                 int8_stages: tuple[bool, ...] | None = None,
                 int8_static: Any = False, s2d_stem: bool = False):
        super().__init__()
        kind, layers = RESNET_SPECS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.s2d_stem = s2d_stem
        self.conv1 = nn.Conv2d(12, 64, 4, 1, 0, bias=False) if s2d_stem \
            else nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        self.stage_channels = []
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(block(
                    cin, planes, stride,
                    int8=bool(int8_stages and int8_stages[stage]),
                    int8_static=int8_static))
                cin = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            self.stage_channels.append(cin)

    def forward(self, x: torch.Tensor, return_skips: bool = False):
        if self.s2d_stem:
            # output i taps x[2i-4 .. 2i+3], the -4 tap a structural zero
            x = F.pad(space_to_depth(x), (2, 1, 2, 1))
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        skips = []
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            skips.append(x)
        if return_skips:
            return x, skips[:-1]
        return x
