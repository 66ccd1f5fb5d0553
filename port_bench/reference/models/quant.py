"""Symmetric W{bits}A{bits} convolution of the reference, in float32.

The reference's own statement of the int8 serving mode of
``rdpn6d_tpu_torch/models/quant.py`` with static activation scales:
weights quantized per output channel from the float32 weight, the
activation by one scalar s = max(amax, 1e-12) / qmax from an absmax that
``calibrate`` records over a batch, round half to even, clipped to
±qmax, the integer sum then times s * sw, in the input's dtype. With ``pre``
(an eval BN) the conv quantizes relu(bn(x)) ++ skip, taken in float32
and rounded to the input's dtype. The weight and the absmax stay float32
under a cast of the module. ``bits`` = 8 is the configuration's
mode (qmax 127); 4 (qmax 7) is the control one precision below it. The
integer convolution runs in float32 with TF32 off (the caller's
setting): exact while a partial sum stays under 2**24, which products of
at most 127 * 127 over the head's 2880 inputs, of either sign, do in all
but a vanishing share of outputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .norm import keep_float32


def qmax_of(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def _quantize(x: torch.Tensor, scale: torch.Tensor, qmax: float
              ) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -qmax, qmax).nan_to_num(0.0)


class Int8Conv(nn.Conv2d):
    """Bias-free conv with ``bits``-bit weights and static activations."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bits: int = 8):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=False)
        self.qmax = qmax_of(bits)
        self.calibrating = False
        self.register_buffer("act_amax", torch.zeros(()), persistent=False)

    def _apply(self, fn, recurse=True):
        return super()._apply(keep_float32(fn), recurse)

    def forward(self, x: torch.Tensor, pre: nn.Module | None = None,
                skip: torch.Tensor | None = None) -> torch.Tensor:
        a = x.float()
        if pre is not None:
            a = torch.relu(F.batch_norm(
                a, pre.running_mean, pre.running_var, pre.weight, pre.bias,
                False, 0.0, pre.eps)).to(x.dtype).float()
            if skip is not None:
                a = torch.cat([a, skip.to(x.dtype).float()], dim=1)
        if self.calibrating:
            self.act_amax.copy_(torch.maximum(self.act_amax, a.abs().amax()))
            return F.conv2d(a, self.weight.float(), None, self.stride,
                            self.padding).to(x.dtype)
        w = self.weight.float()
        sw = (w.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-12)
              / self.qmax)
        s = self.act_amax.float().clamp_min(1e-12) / self.qmax
        acc = F.conv2d(_quantize(a, s, self.qmax),
                       _quantize(w, sw, self.qmax), None, self.stride,
                       self.padding)
        return (acc * (s * sw.reshape(1, -1, 1, 1))).to(x.dtype)


def conv_factory(int8: bool, bits: int = 8):
    """``Int8Conv`` of ``bits`` when ``int8``, else a bias-free conv."""
    def make(cin: int, cout: int, k: int, stride: int = 1,
             padding: int = 0) -> nn.Conv2d:
        if int8:
            return Int8Conv(cin, cout, k, stride, padding, bits)
        return nn.Conv2d(cin, cout, k, stride, padding, bias=False)
    return make


@torch.no_grad()
def calibrate(model: nn.Module, batch: dict) -> None:
    """Record every ``Int8Conv``'s input absmax over ``batch`` (the model
    in eval mode, each conv in float32)."""
    convs = [m for m in model.modules() if isinstance(m, Int8Conv)]
    model.eval()
    for m in convs:
        m.act_amax.zero_()
        m.calibrating = True
    try:
        model(batch)
    finally:
        for m in convs:
            m.calibrating = False
