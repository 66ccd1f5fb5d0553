"""Normalization layers with flax's semantics.

flax's ``BatchNorm(momentum=0.9)`` is torch's ``momentum=0.1``, with eps
1e-5 on both sides; but in train mode flax moves its running variance
toward the BIASED batch variance, where ``nn.BatchNorm2d`` takes the
unbiased one (n / (n - 1) larger). ``BatchNorm2d`` keeps torch's fused
kernel for the forward and corrects the running variance after it.
GroupNorm takes flax's eps, 1e-6 (torch's default is 1e-5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance follows the biased batch
    variance, as flax's does. Eval mode is unchanged."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # the op updates a copy: autograd keeps the running variance it
        # was given, which must not change under it
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            # torch moved by momentum * var_batch * n/(n-1); flax moves by
            # momentum * var_batch
            keep = (1.0 - self.momentum) * self.running_var
            self.running_var.copy_(keep + (var - keep) * ((n - 1) / n))
            self.num_batches_tracked.add_(1)
        return y


def make_norm(kind: str, channels: int, gn_groups: int) -> nn.Module:
    if kind == "BN":
        return BatchNorm2d(channels)
    if kind == "GN":
        return nn.GroupNorm(gn_groups, channels, eps=1e-6)  # flax's eps
    raise ValueError(f"unknown norm: {kind}")
