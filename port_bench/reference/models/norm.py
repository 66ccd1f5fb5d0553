"""Normalization layers of the reference, with flax's semantics.

BatchNorm moves its running variance toward the BIASED batch variance in
train mode, as flax's does (torch's ``nn.BatchNorm2d`` takes the
unbiased one); eps 1e-5, momentum 0.1 (flax's 0.9). GroupNorm takes
flax's eps, 1e-6. Under a bfloat16 cast both keep their
parameters and running statistics float32, normalise in float32 and round
once to the input's dtype. One process, no recompute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


_LOW = (torch.bfloat16, torch.float16)


def keep_float32(fn):
    """``fn`` of ``Module._apply`` leaving float32 tensors float32 where it
    would cast them to a low-precision float."""
    def apply(t):
        out = fn(t)
        if t.dtype == torch.float32 and out.dtype in _LOW:
            out = t.to(device=out.device)
        return out
    return apply


class BatchNorm2d(nn.BatchNorm2d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def _apply(self, fn, recurse=True):
        return super()._apply(keep_float32(fn), recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            keep = (1.0 - self.momentum) * self.running_var
            self.running_var.copy_(keep + (var - keep) * ((n - 1) / n))
            self.num_batches_tracked.add_(1)
        return y


class GroupNorm(nn.GroupNorm):
    def _apply(self, fn, recurse=True):
        return super()._apply(keep_float32(fn), recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype \
                or torch.is_autocast_enabled(x.device.type):
            return super().forward(x)
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


def make_norm(kind: str, channels: int, gn_groups: int) -> nn.Module:
    if kind == "BN":
        return BatchNorm2d(channels)
    if kind == "GN":
        return GroupNorm(gn_groups, channels, eps=1e-6)
    raise ValueError(f"unknown norm: {kind}")
