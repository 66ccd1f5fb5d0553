"""Ranger: gradient centralization -> rectified RAdam -> weight decay -> lr
-> Lookahead, as one ``torch.optim.Optimizer``.

Counterpart of ``rdpn6d_tpu/solver/ranger.py:ranger`` (an optax chain), with
its math, which is the reference's lib/torch_utils/solver/ranger.py:

  * GC subtracts, from each gradient with more than one dim, its mean over
    every dim but dim 0. In torch's layouts dim 0 is the output channel of
    a conv and a linear layer, and the input channel of a transposed conv;
    flax keeps that same axis last and reduces the others, so the two
    centralize the same slices.
  * RAdam with b1 0.95, b2 0.999, eps 1e-5: plain momentum steps m / (1 -
    b1^t) while N_sma <= 5 (steps 1-5), the rectified adaptive step
    afterwards.
  * Decoupled weight decay (u += wd * p), then u *= -lr, with lr read from
    the param group (the train step writes the schedule's value there).
  * Lookahead (alpha 0.5, k 6): every k-th step the fast weights land on
    slow + alpha (fast_new - slow), which becomes the new slow copy.

Like optax, every parameter of the optimizer is stepped every call; a
parameter without a gradient counts as a zero gradient.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.optim import Optimizer


def centralize_(grads: list[torch.Tensor]) -> None:
    """In place, per tensor with dim > 1: g -= mean of g over dims 1..n."""
    for g in grads:
        if g.dim() > 1:
            g.sub_(g.mean(dim=tuple(range(1, g.dim())), keepdim=True))


def radam_step_size(t: int, b1: float, b2: float,
                    n_sma_threshold: float) -> tuple[float, bool]:
    """(step size, adaptive?) of rectified Adam at step t >= 1.

    In float32, operation for operation as the JAX package computes it on
    the device: N_sma subtracts two numbers near 2/(1-b2) (1999 - 1993 at
    step 6), so float64 would move the step by ~5e-5 of itself."""
    f = np.float32
    tt = f(t)
    beta2_t = f(b2) ** tt
    n_sma_max = f(2.0 / (1.0 - b2) - 1.0)
    n_sma = n_sma_max - f(2.0) * tt * beta2_t / (f(1.0) - beta2_t)
    bias1 = f(1.0) - f(b1) ** tt
    if n_sma > n_sma_threshold:
        rect = np.sqrt((f(1.0) - beta2_t) * (n_sma - f(4.0))
                       / (n_sma_max - f(4.0)) * (n_sma - f(2.0)) / n_sma
                       * n_sma_max / (n_sma_max - f(2.0))) / bias1
        return float(rect), True
    return float(f(1.0) / bias1), False


class Ranger(Optimizer):
    def __init__(self, params, lr: float = 1e-4,
                 betas: tuple[float, float] = (0.95, 0.999),
                 eps: float = 1e-5, alpha: float = 0.5, k: int = 6,
                 n_sma_threshold: float = 5.0, weight_decay: float = 0.0,
                 use_gc: bool = True):
        if not 0.0 <= alpha <= 1.0 or k < 1:
            raise ValueError(f"lookahead alpha={alpha}, k={k}")
        super().__init__(params, dict(
            lr=lr, betas=betas, eps=eps, alpha=alpha, k=k,
            n_sma_threshold=n_sma_threshold, weight_decay=weight_decay,
            use_gc=use_gc))

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
            grads = [p.grad.detach().clone() if p.grad is not None
                     else torch.zeros_like(p) for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p].update(
                        step=0, exp_avg=torch.zeros_like(p),
                        exp_avg_sq=torch.zeros_like(p),
                        slow=p.detach().clone())
            states = [self.state[p] for p in params]
            t = states[0]["step"] + 1
            for s in states:
                s["step"] = t
            if group["use_gc"]:
                centralize_(grads)
            ms = [s["exp_avg"] for s in states]
            vs = [s["exp_avg_sq"] for s in states]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, grads, alpha=1.0 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, grads, grads, value=1.0 - b2)

            step_size, adaptive = radam_step_size(
                t, b1, b2, group["n_sma_threshold"])
            if adaptive:
                denom = torch._foreach_sqrt(vs)
                torch._foreach_add_(denom, group["eps"])
                upd = torch._foreach_div(ms, denom)
                torch._foreach_mul_(upd, step_size)
            else:
                upd = torch._foreach_mul(ms, step_size)
            if group["weight_decay"] > 0:
                torch._foreach_add_(upd, params, alpha=group["weight_decay"])
            torch._foreach_mul_(upd, -group["lr"])

            if t % group["k"] == 0:
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
