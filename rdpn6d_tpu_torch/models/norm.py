"""Normalization layers with flax's semantics.

flax's ``BatchNorm(momentum=0.9)`` is torch's ``momentum=0.1``, with eps
1e-5 on both sides; but in train mode flax moves its running variance
toward the BIASED batch variance, where ``nn.BatchNorm2d`` takes the
unbiased one (n / (n - 1) larger). ``BatchNorm2d`` keeps torch's fused
kernel for the forward and corrects the running variance after it.
GroupNorm takes flax's eps, 1e-6 (torch's default is 1e-5).

Under a bfloat16 (or float16) model both keep their parameters and
running statistics float32, as the JAX package's norms do
(``param_dtype=jnp.float32``, float32 batch stats): a cast of the module
leaves them float32 (``_apply``), and they normalise in float32 and round
once to the input's dtype, as flax's ``_normalize`` does. Rounding the
statistics to bfloat16 instead moved ~36% of a 256-channel BN's bfloat16
outputs, by up to 0.5 (``tests/test_torch_norm_dtype.py``).

In train mode inside a process group (``parallel/mesh.py``),
``BatchNorm2d`` normalises by the mean and variance of the GLOBAL batch,
as flax's BatchNorm does inside the JAX package's one program over a
batch-sharded array.

Under ``solver.remat`` (``models/rdpn.py``) a checkpointed region runs its
forward again in the backward pass, inside ``recomputing()``. There
``BatchNorm2d`` normalises as it did (the same op on the same input; in a
process group the same all-reduce, issued in the same order on every
rank) and moves no running statistic, as flax's remat recomputes without
mutating ``batch_stats``.
"""

from __future__ import annotations

import contextlib
import threading
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce_sum, in_group, rank, world

_LOW = (torch.bfloat16, torch.float16)

# set on the thread that re-runs a checkpointed forward (autograd's
# device thread on a card, the caller's on the CPU)
_STATE = threading.local()


@contextlib.contextmanager
def recomputing():
    """The forward of a checkpointed region run again for its backward:
    ``torch.utils.checkpoint``'s recompute context."""
    prev = getattr(_STATE, "recomputing", False)
    _STATE.recomputing = True
    try:
        yield
    finally:
        _STATE.recomputing = prev


def is_recomputing() -> bool:
    return getattr(_STATE, "recomputing", False)


def rsqrt_f32(v: np.ndarray) -> np.ndarray:
    """1 / sqrt(v) of float32 ``v`` > 0, correctly rounded to float32. A
    float64 estimate rounds up to three times (sqrt, division, cast), so
    it may land one float32 ulp off; each estimate r moves to a neighbour
    where exact rationals put the true value past the midpoint m between
    them (1 / sqrt(v) < m iff m² v > 1; no midpoint is hit exactly)."""
    v = np.asarray(v, np.float32)
    out = (1.0 / np.sqrt(v.astype(np.float64))).astype(np.float32)
    for i, (x, r) in enumerate(zip(v.ravel().tolist(), out.ravel())):
        lo = np.nextafter(r, np.float32(0))
        hi = np.nextafter(r, np.float32(np.inf))
        if ((Fraction(float(lo)) + Fraction(float(r))) / 2) ** 2 * \
                Fraction(x) > 1:
            out.flat[i] = lo
        elif ((Fraction(float(r)) + Fraction(float(hi))) / 2) ** 2 * \
                Fraction(x) < 1:
            out.flat[i] = hi
    return out


def keep_float32(fn):
    """``fn`` of ``Module._apply`` that leaves float32 tensors float32
    where it would cast them to a low-precision float (a device move still
    applies)."""
    def apply(t):
        out = fn(t)
        if t.dtype == torch.float32 and out.dtype in _LOW:
            out = t.to(device=out.device)
        return out
    return apply


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance follows the biased batch
    variance, as flax's does, and whose parameters and statistics stay
    float32 under a low-precision cast (torch's kernel then normalises in
    float32 and writes the input's dtype). Eval mode is torch's."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self._folded: tuple | None = None

    def _apply(self, fn, recurse=True):
        self._folded = None
        return super()._apply(keep_float32(fn), recurse)

    def folded(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean, mul, bias), float32 [C] on the module's device: the eval
        BN as fma(x - mean, mul, bias), flax's ``_normalize`` order, with
        mul = rsqrt(var + eps) * weight. var + eps and the product by the
        weight round in float32 as flax's do; the rsqrt is correctly
        rounded (``rsqrt_f32``; XLA's CPU rsqrt is not). The same bits on
        every device; cached until a parameter or statistic changes."""
        ts = (self.running_mean, self.running_var, self.weight, self.bias)
        key = tuple((t.data_ptr(), t._version) for t in ts) \
            + (self.weight.device,)
        if self._folded is not None and self._folded[0] == key:
            return self._folded[1]
        with torch.no_grad():
            var = self.running_var.detach().float().cpu() + self.eps
            rs = torch.from_numpy(rsqrt_f32(var.numpy()))
            mul = rs * self.weight.detach().float().cpu()
            dev = self.weight.device
            value = (self.running_mean.detach().float().contiguous(),
                     mul.to(dev), self.bias.detach().float().contiguous())
        self._folded = (key, value)
        return value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if in_group():
            return self._forward_global(x)
        # the op updates a copy: autograd keeps the running variance it
        # was given, which must not change under it. A recompute updates
        # copies of both and keeps neither
        recompute = is_recomputing()
        mean = self.running_mean.clone() if recompute else self.running_mean
        var = self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        if recompute:
            return y
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            # torch moved by momentum * var_batch * n/(n-1); flax moves by
            # momentum * var_batch
            keep = (1.0 - self.momentum) * self.running_var
            self.running_var.copy_(keep + (var - keep) * ((n - 1) / n))
            self.num_batches_tracked.add_(1)
        return y

    def _forward_global(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode in a process group: ``_GlobalBatchNorm``, then the
        running statistics moved with the global batch's, so every rank
        holds the same."""
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                              self.eps)
        if is_recomputing():
            return y
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        return y


def _moments(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype in _LOW else x


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch normalisation over the GLOBAL batch of a process group, each
    rank holding its rows: (y, mean, biased var) of this rank's x.

    Forward: each rank's mean, biased variance and count of its own batch
    (float32, or float64 for a float64 input) go into its row of a
    [world, 2C + 1] table, summed over the ranks by one all-reduce; the
    global moments combine the rows (Chan et al.: no E[x²] - E[x]²
    cancellation); torch's fused kernel normalises with them, in float32,
    and writes the input's dtype. Backward, the analytic BN gradient with
    the global sums of dy and dy (x - mean) (one all-reduce) and the
    global count; the weight and bias gradients are this rank's shares,
    which the train step's gradient all-reduce sums."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        C = x.shape[1]
        xm = _moments(x)
        var_r, mean_r = torch.var_mean(xm, dim=(0, 2, 3), correction=0)
        row = torch.cat([mean_r, var_r, mean_r.new_full(
            (1,), float(xm.numel() // C))])
        table = row.new_zeros(world(), 2 * C + 1)
        table[rank()] = row
        table = all_reduce_sum(table)
        means, vars_, ns = table[:, :C], table[:, C:2 * C], table[:, 2 * C:]
        n = ns.sum()
        mean = (ns * means).sum(0) / n
        var = (ns * (vars_ + (means - mean).square())).sum(0) / n
        y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        C = x.shape[1]
        dyf = _moments(dy)
        xmu = _moments(x) - mean[:, None, None]
        sum_dy = dyf.sum((0, 2, 3))
        sum_dy_xmu = (dyf * xmu).sum((0, 2, 3))
        g = all_reduce_sum(torch.cat([sum_dy, sum_dy_xmu]))
        mean_dy = (g[:C] / n)[:, None, None]
        proj = (invstd * invstd * g[C:] / n)[:, None, None]
        dx = (dyf - mean_dy - xmu * proj) * (invstd * weight)[:, None, None]
        return dx.to(x.dtype), sum_dy_xmu * invstd, sum_dy, None


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` whose parameters stay float32 under a
    low-precision cast; a low-precision input is normalised in float32 and
    rounded once to its dtype, as flax's ``GroupNorm`` does."""

    def _apply(self, fn, recurse=True):
        return super()._apply(keep_float32(fn), recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # autocast runs group_norm in float32 itself (training)
        if x.dtype == self.weight.dtype \
                or torch.is_autocast_enabled(x.device.type):
            return super().forward(x)
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


def make_norm(kind: str, channels: int, gn_groups: int) -> nn.Module:
    if kind == "BN":
        return BatchNorm2d(channels)
    if kind == "GN":
        return GroupNorm(gn_groups, channels, eps=1e-6)  # flax's eps
    raise ValueError(f"unknown norm: {kind}")
