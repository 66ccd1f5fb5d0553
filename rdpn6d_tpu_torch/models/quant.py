"""W8A8 int8 serving: ``Int8Conv`` and its calibration.

Counterpart of ``rdpn6d_tpu/models/quant.py`` (``Int8Conv``,
``conv_factory``, ``calibrate_quant``). ``Int8Conv`` is an ``nn.Conv2d``
(bias-free) with the same ``weight``, so checkpoints and the flax weight
carrier are unchanged for parameters; its calibrated activation absmax is a
non-persistent buffer ``act_amax`` (a scalar, or one value per input channel
for "per_channel"), carried to and from the JAX package's ``quant``
collection by ``utils/flax_params``.

The four modes of the JAX package's ``Int8Conv``:
- calibration (``calibrate_quant`` sets ``calibrating``): the conv runs in
  float32 on the float32 weight, records the running absmax of its input,
  and casts its output to the input's dtype;
- per-channel (``static_act="per_channel"``): SmoothQuant's balance
  t_c = sqrt(max(amax_c, 1e-12) / wmax_c), activations quantized by the
  static scalar s = max(max_c(amax_c / t_c), 1e-12) / 127 after dividing
  by t_c, weights quantized after multiplying by t_c;
- static (``static_act=True``): s = max(amax, 1e-12) / 127, a scalar;
- dynamic (the default): s per sample from the sample's absmax.
A conv may take a folded pre-op (``forward(y, pre, skip)``): ``pre`` is the
eval ``BatchNorm2d`` before it (its ReLU implied) and ``skip`` channels
appended after it, so that the conv quantizes relu(bn(y)) ++ skip in one
``bn_relu_quantize`` pass, as the JAX package's XLA fuses the requantize
into the BN and ReLU before it; calibration records the absmax of exactly
those values (``ops/int8_conv.bn_relu_plain``).
Weights are quantized per output channel from the float32 weight. The
weight and ``act_amax`` stay float32 when the module is cast to another
floating dtype (``_apply``), as the JAX package keeps ``kernel`` in float32
under a bfloat16 model; the quantized weight is cached until the weight or
the calibrated absmax changes. Inference only: no gradient is defined.
"""

from __future__ import annotations

from typing import Any, Iterable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_conv import (
    bn_relu_plain,
    bn_relu_quantize,
    int8_conv,
    pack_weight,
    quantize_act,
    quantize_symmetric,
)
from .norm import keep_float32


class Int8Conv(nn.Conv2d):
    """Bias-free ``nn.Conv2d`` whose contraction runs in int8 (see the
    module docstring for ``static_act``). Output dtype = the input's."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, static_act: Any = False):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=False)
        self.static_act = static_act
        self.per_channel = static_act == "per_channel"
        self.calibrating = False
        if static_act:
            shape = (in_channels,) if self.per_channel else ()
            self.register_buffer("act_amax", torch.zeros(shape),
                                 persistent=False)
        else:
            self.act_amax = None
        self._cache: tuple | None = None

    def _apply(self, fn, recurse=True):
        self._cache = None
        return super()._apply(keep_float32(fn), recurse)

    def quantized(self) -> tuple[torch.Tensor, torch.Tensor,
                                 torch.Tensor | None, torch.Tensor | None]:
        """(wq [N,kh,kw,Cp] int8, sw [N], amax, t): the packed weight and
        its per-output-channel scale, the activation's scalar absmax
        (static; per channel the smoothed one) and the SmoothQuant factors
        (per channel), from the float32 weight; cached."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.device) + (
            () if self.act_amax is None else (self.act_amax._version,))
        if self._cache is not None and self._cache[0] == key:
            return self._cache[1]
        with torch.no_grad():
            wf = w.float()
            amax = t = None
            if self.per_channel:
                a = self.act_amax
                wmax = wf.abs().amax(dim=(0, 2, 3)).clamp_min(1e-12)
                # the float32 sqrt correctly rounded, as XLA's: PyTorch's
                # vectorized CPU sqrt is not, and float64 then float32
                # rounds once in effect (53 >= 2 * 24 + 2 bits)
                t = torch.sqrt((a.clamp_min(1e-12) / wmax).double()).float()
                amax = (a / t).amax()
                wf = wf * t[None, :, None, None]
            elif self.static_act:
                amax = self.act_amax
            wq, sw = quantize_symmetric(wf, dim=(1, 2, 3))
            value = (pack_weight(wq), sw.reshape(-1), amax, t)
        self._cache = (key, value)
        return value

    def forward(self, x: torch.Tensor, pre: nn.Module | None = None,
                skip: torch.Tensor | None = None) -> torch.Tensor:
        """x [B,C,H,W] -> the conv's output in x's dtype. With ``pre`` (an
        eval ``BatchNorm2d``, or anything with its ``folded()``) x is that
        BN's input and the conv takes relu(pre(x)), then ``skip`` on the
        channel axis."""
        if pre is None and skip is not None:
            raise ValueError("Int8Conv: a skip is folded only behind a BN")
        if self.calibrating:
            with torch.no_grad(), torch.autocast(x.device.type,
                                                 enabled=False):
                a = x if pre is None else bn_relu_plain(x, *pre.folded(),
                                                        skip)
                xf = a.float()
                dims = (0, 2, 3) if self.per_channel else None
                seen = xf.abs().amax() if dims is None \
                    else xf.abs().amax(dim=dims)
                self.act_amax.copy_(torch.maximum(self.act_amax, seen))
                y = F.conv2d(xf, self.weight.float(), None, self.stride,
                             self.padding)
            return y.to(x.dtype)
        wq, sw, amax, t = self.quantized()
        mode = "per_channel" if self.per_channel else \
            "static" if self.static_act else "dynamic"
        if pre is None:
            xq, sx = quantize_act(x, mode, amax, t)
        else:
            xq, sx = bn_relu_quantize(x, *pre.folded(), mode, amax, t, skip)
        return int8_conv(xq, sx, wq, sw, self.stride[0], self.padding[0],
                         x.dtype)


def conv_factory(int8: bool, static_act: Any = False):
    """A constructor for the trunk's and the head's convs: ``Int8Conv``
    when ``int8``, else a bias-free ``nn.Conv2d``."""
    def make(cin: int, cout: int, k: int, stride: int = 1,
             padding: int = 0) -> nn.Conv2d:
        if int8:
            return Int8Conv(cin, cout, k, stride, padding, static_act)
        return nn.Conv2d(cin, cout, k, stride, padding, bias=False)
    return make


def static_convs(model: nn.Module) -> dict[str, Int8Conv]:
    """The model's ``Int8Conv`` modules that serve with static scales."""
    return {n: m for n, m in model.named_modules()
            if isinstance(m, Int8Conv) and m.static_act}


@torch.no_grad()
def calibrate_quant(model: nn.Module, batches: Iterable
                    ) -> dict[str, torch.Tensor]:
    """Record every static ``Int8Conv``'s input absmax over ``batches``
    (each convolution in full precision, the model in eval mode) and return
    them by module name; the model serves with them from then on.

    Raises ValueError on an empty ``batches``, on a model with nothing to
    calibrate, and on a conv whose recorded absmax is all zero (it would
    serve with a ~1e-14 scale, clipping every later input to ±127)."""
    convs = static_convs(model)
    was_training = model.training
    model.eval()
    n = 0
    try:
        for m in convs.values():
            m.act_amax.zero_()
            m.calibrating = True
        for batch in batches:
            if not convs:
                raise ValueError(
                    "calibrate_quant needs a model built with int8 enabled "
                    "and int8_static=True — no conv records an activation "
                    "scale (got a full-precision model?)")
            model(batch)
            n += 1
    finally:
        for m in convs.values():
            m.calibrating = False
        model.train(was_training)
    if n == 0:
        raise ValueError("calibrate_quant got an empty batches iterable — "
                         "there is nothing to take the scales from")
    zeros = [name for name, m in convs.items()
             if float(m.act_amax.abs().max()) == 0.0]
    if zeros:
        raise ValueError(
            "calibration recorded a ZERO activation absmax for "
            f"{zeros} — the calibration batches never exercised these "
            "convs (all-zero inputs); calibrate on more representative "
            "batches")
    return {name: m.act_amax.clone() for name, m in convs.items()}


def serving_mode(cfg) -> tuple[Any, Any]:
    """(int8, int8_static) of the serving model from ``cfg.test``:
    ``int8_static`` without ``int8`` serves full precision, as the JAX
    package's eval runner has it."""
    int8 = cfg.test.int8 or False
    return int8, cfg.test.int8_static if int8 else False


def trunk_stage_mask(int8: Any) -> tuple[bool, ...] | None:
    """('trunkN' mode) the 4-stage mask quantizing only stage N."""
    if isinstance(int8, str) and len(int8) == 6 and int8.startswith("trunk") \
            and int8[5].isdigit():
        n = int(int8[5])
        if n > 3:
            # an all-False mask would quantize nothing while reporting
            # itself as int8-trunkN
            raise ValueError(f"int8={int8!r}: trunk stages are "
                             "trunk0..trunk3")
        return tuple(s == n for s in range(4))
    return None


def int8_targets(int8: Any) -> tuple[tuple[bool, ...] | None, bool]:
    """(trunk stage mask or None, head quantized) of an ``int8`` mode:
    False | "" | True | "all" | "head" | "trunk" | "trunk0".."trunk3"."""
    mask = trunk_stage_mask(int8)
    if int8 not in (False, "", True, "all", "head", "trunk") and mask is None:
        # an unrecognized mode would serve full precision while logs and
        # CSVs attribute the numbers to int8
        raise ValueError(f"int8={int8!r}: expected False|True|'all'|'head'|"
                         "'trunk'|'trunk0'..'trunk3'")
    if int8 in (True, "all", "trunk"):
        mask = (True,) * 4
    return mask, int8 in (True, "all", "head")
