"""Ranger of the reference: gradient centralization -> rectified RAdam ->
weight decay -> lr -> Lookahead.

A frozen copy of ``rdpn6d_tpu_torch/solver/ranger.py``'s ``Ranger`` (b1
0.95, b2 0.999, eps 1e-5; plain momentum steps m / (1 - b1^t) while
N_sma <= 5, the rectified adaptive step afterwards; Lookahead alpha 0.5,
k 6). The benchmark reads the first gradient back from ``exp_avg``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.optim import Optimizer


def centralize_(grads: list[torch.Tensor], conv_only: bool = False) -> None:
    """In place, per tensor with dim > 1 (dim > 3 with ``conv_only``):
    g -= mean of g over dims 1..n."""
    min_dim = 3 if conv_only else 1
    for g in grads:
        if g.dim() > min_dim:
            g.sub_(g.mean(dim=tuple(range(1, g.dim())), keepdim=True))


def radam_step_size(t: int, b1: float, b2: float, n_sma_threshold: float,
                    inclusive: bool = False) -> tuple[float, bool]:
    """(step size, adaptive?) of rectified Adam at step t >= 1; adaptive
    where N_sma > threshold (>= with ``inclusive``, Ralamb's test).

    In float32, operation for operation as the JAX package computes it on
    the device: N_sma subtracts two numbers near 2/(1-b2) (1999 - 1993 at
    step 6), so float64 would move the step by ~5e-5 of itself."""
    f = np.float32
    tt = f(t)
    beta2_t = f(b2) ** tt
    n_sma_max = f(2.0 / (1.0 - b2) - 1.0)
    n_sma = n_sma_max - f(2.0) * tt * beta2_t / (f(1.0) - beta2_t)
    bias1 = f(1.0) - f(b1) ** tt
    if n_sma >= n_sma_threshold if inclusive else n_sma > n_sma_threshold:
        rect = np.sqrt((f(1.0) - beta2_t) * (n_sma - f(4.0))
                       / (n_sma_max - f(4.0)) * (n_sma - f(2.0)) / n_sma
                       * n_sma_max / (n_sma_max - f(2.0))) / bias1
        return float(rect), True
    return float(f(1.0) / bias1), False


def grads_of(params: list[torch.Tensor]) -> list[torch.Tensor]:
    """Copies of the gradients, zeros where a parameter has none."""
    return [p.grad.detach().clone() if p.grad is not None
            else torch.zeros_like(p) for p in params]


def count_step(state, params: list[torch.Tensor], **init) -> int:
    """Initialise each parameter's state with ``step`` 0 and ``init``'s
    entries (name -> function of the parameter) on its first step, then
    advance every step count; returns this step's 1-based count."""
    for p in params:
        if not state[p]:
            state[p].update(step=0, **{k: fn(p) for k, fn in init.items()})
    t = state[params[0]]["step"] + 1
    for p in params:
        state[p]["step"] = t
    return t


def _zeros(p):
    return torch.zeros_like(p)


class Ranger(Optimizer):
    """GC -> rectified RAdam -> weight decay -> lr -> Lookahead; ``k=None``
    leaves Lookahead out (``RAdam``)."""

    def __init__(self, params, lr: float = 1e-4,
                 betas: tuple[float, float] = (0.95, 0.999),
                 eps: float = 1e-5, alpha: float = 0.5, k: int | None = 6,
                 n_sma_threshold: float = 5.0, weight_decay: float = 0.0,
                 use_gc: bool = True, gc_conv_only: bool = False,
                 belief: bool = False):
        if not 0.0 <= alpha <= 1.0 or (k is not None and k < 1):
            raise ValueError(f"lookahead alpha={alpha}, k={k}")
        super().__init__(params, dict(
            lr=lr, betas=betas, eps=eps, alpha=alpha, k=k,
            n_sma_threshold=n_sma_threshold, weight_decay=weight_decay,
            use_gc=use_gc, gc_conv_only=gc_conv_only, belief=belief))

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
            eps = group["eps"]
            grads = grads_of(params)
            init = dict(exp_avg=_zeros, exp_avg_sq=_zeros)
            if group["k"] is not None:
                init["slow"] = lambda p: p.detach().clone()
            t = count_step(self.state, params, **init)
            states = [self.state[p] for p in params]
            if group["use_gc"]:
                centralize_(grads, group["gc_conv_only"])
            ms = [s["exp_avg"] for s in states]
            vs = [s["exp_avg_sq"] for s in states]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, grads, alpha=1.0 - b1)
            torch._foreach_mul_(vs, b2)
            if group["belief"]:
                # the residual against the NEW first moment
                res = torch._foreach_sub(grads, ms)
                torch._foreach_addcmul_(vs, res, res, value=1.0 - b2)
            else:
                torch._foreach_addcmul_(vs, grads, grads, value=1.0 - b2)

            step_size, adaptive = radam_step_size(
                t, b1, b2, group["n_sma_threshold"])
            if adaptive:
                if group["belief"]:
                    denom = torch._foreach_add(vs, eps)
                    torch._foreach_sqrt_(denom)
                else:
                    denom = torch._foreach_sqrt(vs)
                torch._foreach_add_(denom, eps)
                upd = torch._foreach_div(ms, denom)
                torch._foreach_mul_(upd, step_size)
            else:
                upd = torch._foreach_mul(ms, step_size)
            if group["weight_decay"] > 0:
                torch._foreach_add_(upd, params, alpha=group["weight_decay"])
            torch._foreach_mul_(upd, -group["lr"])

            if group["k"] is not None and t % group["k"] == 0:
                slows = [s["slow"] for s in states]
                torch._foreach_add_(upd, params)          # fast weights
                torch._foreach_sub_(upd, slows)
                torch._foreach_mul_(upd, group["alpha"])
                torch._foreach_add_(upd, slows)           # synced
                torch._foreach_copy_(params, upd)
                torch._foreach_copy_(slows, upd)
            else:
                torch._foreach_add_(params, upd)
        return loss
