"""The optax update rules the JAX package calls for ``rmsprop_tf``,
``adabelief``, ``sgd_gc`` and ``sgd_gcc``, as ``torch.optim.Optimizer``
subclasses: a copy of optax 0.2.6's math (``optax.rmsprop``,
``optax.adabelief``, ``optax.sgd``), since the port does not import optax.

  * ``RMSpropTF`` is ``optax.rmsprop(decay=0.9, eps=1e-10,
    initial_scale=1.0, momentum=0.9)``: nu starts at ones, eps sits inside
    the square root (g / sqrt(nu + eps)), and the momentum traces the
    lr-scaled step. ``torch.optim.RMSprop`` does none of these.
  * ``AdaBelief`` is ``optax.adabelief``'s defaults: b1 0.9, b2 0.999,
    eps 1e-16 and eps_root 1e-16, which is added to the stored nu and so
    accumulates from step to step; bias-corrected moments.
  * ``SGDGC`` centralizes the gradients (all tensors with dim > 1, or
    conv kernels only), then ``optax.sgd(momentum=0.9)``: trace = g + 0.9
    trace, p -= lr · trace.

Every parameter is stepped every call; a parameter without a gradient
counts as a zero gradient.
"""

from __future__ import annotations

import torch
from torch.optim import Optimizer

from .ranger import bias_correction, centralize_, count_step, grads_of


def _ones(p):
    return torch.ones_like(p)


class RMSpropTF(Optimizer):
    def __init__(self, params, lr: float = 1e-3, decay: float = 0.9,
                 eps: float = 1e-10, initial_scale: float = 1.0,
                 momentum: float = 0.9):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      initial_scale=initial_scale,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            decay = group["decay"]
            grads = grads_of(params)
            scale = group["initial_scale"]
            count_step(self.state, params,
                       square_avg=lambda p: torch.full_like(p, scale),
                       momentum_buffer=torch.zeros_like)
            nus = [self.state[p]["square_avg"] for p in params]
            bufs = [self.state[p]["momentum_buffer"] for p in params]
            torch._foreach_mul_(nus, decay)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - decay)
            scaling = torch._foreach_add(nus, group["eps"])
            torch._foreach_rsqrt_(scaling)
            torch._foreach_mul_(scaling, grads)
            torch._foreach_mul_(scaling, -group["lr"])
            torch._foreach_mul_(bufs, group["momentum"])
            torch._foreach_add_(bufs, scaling)
            torch._foreach_add_(params, bufs)
        return loss


class AdaBelief(Optimizer):
    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-16, eps_root: float = 1e-16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      eps_root=eps_root))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads = grads_of(params)
            t = count_step(self.state, params, exp_avg=torch.zeros_like,
                           exp_avg_var=torch.zeros_like)
            ms = [self.state[p]["exp_avg"] for p in params]
            vs = [self.state[p]["exp_avg_var"] for p in params]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, grads, alpha=1.0 - b1)
            res = torch._foreach_sub(grads, ms)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, res, res, value=1.0 - b2)
            torch._foreach_add_(vs, group["eps_root"])
            denom = torch._foreach_div(vs, bias_correction(b2, t))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(ms, bias_correction(b1, t))
            torch._foreach_div_(upd, denom)
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)
        return loss


class SGDGC(Optimizer):
    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.9,
                 conv_only: bool = False):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      conv_only=conv_only))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            grads = grads_of(params)
            centralize_(grads, group["conv_only"])
            count_step(self.state, params, momentum_buffer=torch.zeros_like)
            bufs = [self.state[p]["momentum_buffer"] for p in params]
            torch._foreach_mul_(bufs, group["momentum"])
            torch._foreach_add_(bufs, grads)
            torch._foreach_add_(params, bufs, alpha=-group["lr"])
        return loss
