"""ResNet trunk, NCHW, with torchvision's module names.

Counterpart of ``rdpn6d_tpu/models/resnet.py`` (``BasicBlock``,
``Bottleneck``, ``ResNetTrunk``). Names follow torchvision
(``conv1``/``bn1``/``layerN.i.{conv,bn}k``/``downsample``), which is the
reference checkpoint's ``backbone.*`` layout. The space-to-depth stem is
not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

RESNET_SPECS: dict[int, tuple[str, tuple[int, ...]]] = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)  # flax momentum 0.9


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride, bias=False), _bn(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        idt = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + idt)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * 4
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, out, 1, stride, bias=False), _bn(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idt = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + idt)


class ResNetTrunk(nn.Module):
    """conv7x7/2 + maxpool/2 + 4 stages: 256² RGB -> 8x8 final feature."""

    def __init__(self, depth: int = 34):
        super().__init__()
        kind, layers = RESNET_SPECS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        self.stage_channels = []
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(block(cin, planes, stride))
                cin = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            self.stage_channels.append(cin)

    def forward(self, x: torch.Tensor, return_skips: bool = False):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        skips = []
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            skips.append(x)
        if return_skips:
            return x, skips[:-1]
        return x
