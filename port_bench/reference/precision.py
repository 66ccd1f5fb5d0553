"""The control's precision for training: the reference's convolutions and
linear layers computed in float8, one precision below the bfloat16
compute that the train configurations state.

``Float8Compute`` is a ``TorchFunctionMode``: inside it every ``conv2d``,
``conv_transpose2d`` and ``linear`` (the layers that bf16 autocast takes
to bfloat16 in the program, which rounds their operands and their
outputs) takes its input and weight rounded to e4m3 and rounds its output
to e4m3, each under a per-tensor scale onto e4m3's range (448); in the
backward pass the gradient reaching each output is rounded to e5m2 (range
57344), as float8 training keeps its gradients, and flows on unrounded
through the operands' roundings. Everything else stays float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

_FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` under a per-tensor scale, in x's dtype."""
    scale = x.abs().amax().float().clamp_min(1e-30) / _FORMATS[dtype]
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return round_fp8(y, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2)


_OPS = {F.conv2d, F.conv_transpose2d, F.linear}


class Float8Compute(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _OPS:
            return func(*args, **kwargs)
        args = (_Operand.apply(args[0]), _Operand.apply(args[1])) \
            + tuple(args[2:])
        return _Output.apply(func(*args, **kwargs))

