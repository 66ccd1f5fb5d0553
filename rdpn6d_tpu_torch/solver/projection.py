"""AdamP / SGDP: projection optimizers for scale-invariant weights.

Counterpart of ``rdpn6d_tpu/solver/projection.py`` (the reference's
lib/torch_utils/solver/adamp.py and sgdp.py; Heo et al., "AdamP: Slowing
Down the Slowdown for Momentum Optimizers on Scale-invariant Weights").
Where the gradient is near-orthogonal to the weight (|cosine| below
delta / sqrt(cols) in a per-row or a whole-tensor view), the radial
component of the update is projected out and weight decay is damped by
``wd_ratio``.

The per-row view is the JAX package's: rows along axis 0 of the FLAX
layout of the tensor, not along torch's dim 0. Flax's axis 0 is a conv's
(or a transposed conv's) kernel height, torch's dim 2, and a linear
layer's input features, torch's dim 1 (``utils/flax_params.py`` maps the
layouts): a row is every element at one index of that dim, reduced in
place without a copy. The whole-tensor view is the same in both layouts,
and both views ignore the order of rows and of the elements in a row, so
fc1's flatten permutation changes nothing. The decision stays on the
device (``torch.where``): no host sync a tensor. Each tensor's last
decision is its state's ``projected``.

Both emit the full update with the lr folded in and read the lr from the
param group, which the train step fills with the schedule at the 1-based
count (``solver.schedule_step``), as these two read it in the JAX package.
"""

from __future__ import annotations

import math

import torch
from torch.optim import Optimizer

from .ranger import bias_correction, count_step, grads_of

__all__ = ["AdamP", "SGDP", "project_scale_invariant", "cosine_ratios",
           "flax_row_dim"]


def flax_row_dim(p: torch.Tensor) -> int:
    """The torch dim of ``p`` that is its flax layout's axis 0: a 4-D conv
    or transposed-conv weight's dim 2 (the kernel height), a 2-D linear
    weight's dim 1 (the input features)."""
    if p.dim() == 4:
        return 2
    if p.dim() == 2:
        return 1
    raise ValueError(f"no flax layout for a {p.dim()}-D tensor")


def _abs_cos(a, b, dims, eps: float) -> torch.Tensor:
    """|cosine| of a and b over ``dims`` (a row each index of the rest):
    a.b / max(||a|| ||b||, eps)."""
    dot = (a * b).sum(dims)
    denom = torch.clamp(torch.linalg.vector_norm(a, dim=dims)
                        * torch.linalg.vector_norm(b, dim=dims), min=eps)
    return (dot / denom).abs()


def _project(p, u, dims, eps: float) -> torch.Tensor:
    """``u`` less its component along ``p``, a row at a time over
    ``dims``."""
    p_n = p / (torch.linalg.vector_norm(p, dim=dims, keepdim=True) + eps)
    return u - p_n * (p_n * u).sum(dims, keepdim=True)


def _views(p: torch.Tensor) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The dims reduced in the per-row view and in the whole-tensor view."""
    row = flax_row_dim(p)
    return (tuple(d for d in range(p.dim()) if d != row),
            tuple(range(p.dim())))


def cosine_ratios(p: torch.Tensor, g: torch.Tensor, delta: float,
                  eps: float) -> torch.Tensor:
    """[2]: the largest |cosine| of the per-row and of the whole-tensor
    view, each over its threshold delta / sqrt(cols); a view projects
    where its ratio is below 1."""
    per_row, whole = _views(p)
    cols = p.numel() // p.shape[flax_row_dim(p)]
    cos_c = _abs_cos(g, p, per_row, eps).max()
    cos_l = _abs_cos(g, p, whole, eps)
    return torch.stack([cos_c / (delta / math.sqrt(cols)),
                        cos_l / (delta / math.sqrt(p.numel()))])


def project_scale_invariant(p: torch.Tensor, g: torch.Tensor,
                            u: torch.Tensor, delta: float, eps: float
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The two-view cascade for one tensor: (new update, projected), where
    ``projected`` is a 0-d bool tensor. Tensors of dim <= 1 pass."""
    if p.dim() <= 1:
        return u, torch.zeros((), dtype=torch.bool, device=p.device)
    per_row, whole = _views(p)
    ratios = cosine_ratios(p, g, delta, eps)
    cond_c, cond_l = ratios[0] < 1.0, ratios[1] < 1.0
    new = torch.where(cond_c, _project(p, u, per_row, eps),
                      torch.where(cond_l, _project(p, u, whole, eps), u))
    return new, cond_c | cond_l


class AdamP(Optimizer):
    """Adam moments -> projection -> decoupled weight decay damped by
    ``wd_ratio`` on projected tensors -> step."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 delta: float = 0.1, wd_ratio: float = 0.1,
                 nesterov: bool = False):
        super().__init__(params, dict(
            lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
            delta=delta, wd_ratio=wd_ratio, nesterov=nesterov))

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
            lr, eps = group["lr"], group["eps"]
            grads = grads_of(params)
            t = count_step(self.state, params,
                           exp_avg=torch.zeros_like,
                           exp_avg_sq=torch.zeros_like)
            ms = [self.state[p]["exp_avg"] for p in params]
            vs = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, grads, alpha=1.0 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, grads, grads, value=1.0 - b2)
            step_size = lr / bias_correction(b1, t)
            denom = torch._foreach_sqrt(vs)
            torch._foreach_div_(denom, math.sqrt(bias_correction(b2, t)))
            torch._foreach_add_(denom, eps)
            if group["nesterov"]:
                num = torch._foreach_mul(ms, b1)
                torch._foreach_add_(num, grads, alpha=1.0 - b1)
            else:
                num = ms
            perturb = torch._foreach_div(num, denom)
            _step(self.state, params, grads, perturb, group, step_size,
                  lr * group["weight_decay"])
        return loss


class SGDP(Optimizer):
    """SGD with momentum -> the same projection; decoupled weight decay
    lr·wd·wd_ratio / (1 - momentum) on projected tensors (the reference's
    compensation for decoupling), lr·wd / (1 - momentum) elsewhere."""

    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.9,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, eps: float = 1e-8,
                 delta: float = 0.1, wd_ratio: float = 0.1):
        super().__init__(params, dict(
            lr=lr, momentum=momentum, dampening=dampening,
            weight_decay=weight_decay, nesterov=nesterov, eps=eps,
            delta=delta, wd_ratio=wd_ratio))

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
            mom, lr = group["momentum"], group["lr"]
            grads = grads_of(params)
            count_step(self.state, params, momentum_buffer=torch.zeros_like)
            bufs = [self.state[p]["momentum_buffer"] for p in params]
            torch._foreach_mul_(bufs, mom)
            torch._foreach_add_(bufs, grads, alpha=1.0 - group["dampening"])
            if group["nesterov"]:
                d_p = torch._foreach_mul(bufs, mom)
                torch._foreach_add_(d_p, grads)
            else:
                d_p = bufs
            _step(self.state, params, grads, d_p, group, lr,
                  lr * group["weight_decay"] / (1.0 - mom))
        return loss


def _step(state, params, grads, directions, group, step_size: float,
          decay: float) -> None:
    """p -= step_size · projected direction + decay · (wd_ratio where
    projected, else 1) · p, a tensor at a time."""
    for p, g, d in zip(params, grads, directions):
        d, projected = project_scale_invariant(p, g, d, group["delta"],
                                               group["eps"])
        state[p]["projected"] = projected
        upd = d * -step_size
        if decay > 0:
            wd = torch.where(projected, group["wd_ratio"], 1.0)
            upd = upd - (decay * wd).to(p.dtype) * p
        p.add_(upd)
