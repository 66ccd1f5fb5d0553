"""Ranger and its relatives: gradient centralization -> rectified RAdam ->
weight decay -> lr -> Lookahead, as ``torch.optim.Optimizer`` subclasses.

Counterpart of ``rdpn6d_tpu/solver/ranger.py`` (optax chains), with its
math, which is the reference's lib/torch_utils/solver/ranger.py,
ranger_adabelief.py, ralamb.py and over9000.py:

  * GC subtracts, from each gradient with more than one dim, its mean over
    every dim but dim 0. In torch's layouts dim 0 is the output channel of
    a conv and a linear layer, and the input channel of a transposed conv;
    flax keeps that same axis last and reduces the others, so the two
    centralize the same slices. ``gc_conv_only`` centralizes conv kernels
    only (dim > 3), as the reference's GCC variant.
  * RAdam with b1 0.95, b2 0.999, eps 1e-5: plain momentum steps m / (1 -
    b1^t) while N_sma <= 5 (steps 1-5), the rectified adaptive step
    afterwards. ``belief`` is AdaBelief's variant: the second moment
    tracks the residual (g - m)^2 and the denominator is sqrt(v + eps) +
    eps.
  * Decoupled weight decay (u += wd * p), then u *= -lr, with lr read from
    the param group (the train step writes the schedule's value there).
  * Lookahead (alpha 0.5, k 6): every k-th step the fast weights land on
    slow + alpha (fast_new - slow), which becomes the new slow copy.
    ``Lookahead`` wraps any optimizer the same way (rangerlars,
    lookahead_adam).
  * ``Ralamb``: RAdam with a LARS-style trust ratio a tensor, the adaptive
    step from N_sma >= 5.

Like optax, every parameter of these optimizers is stepped every call; a
parameter without a gradient counts as a zero gradient.
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


def bias_correction(b: float, t: int) -> float:
    """1 - b^t in float32, as the JAX package takes it from the count."""
    return float(np.float32(1.0) - np.float32(b) ** np.float32(t))


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


class RAdam(Ranger):
    """The JAX package's ``radam``: rectified RAdam (b1 0.9, eps 1e-8, the
    N_sma > 5 threshold and its float32 step size) without GC, weight
    decay or Lookahead. Not ``torch.optim.RAdam``, whose float64 N_sma
    moves the step by ~5e-5 of itself."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, lr=lr, betas=betas, eps=eps, k=None,
                         use_gc=False)


class Lookahead(Optimizer):
    """Lookahead around ``optimizer``: after its step, every k-th call
    lands the fast weights on slow + alpha (fast - slow), which becomes
    the slow copy (the weights before the first step, at the start).

    The wrapper shares the wrapped optimizer's param groups and state: the
    slow copy is each parameter's ``lookahead_slow`` entry and the call
    count each group's ``lookahead_step``, so ``state_dict`` and
    ``load_state_dict`` carry both."""

    def __init__(self, optimizer: Optimizer, alpha: float = 0.5, k: int = 6):
        if not 0.0 <= alpha <= 1.0 or k < 1:
            raise ValueError(f"lookahead alpha={alpha}, k={k}")
        self.optimizer = optimizer
        super().__init__(optimizer.param_groups, optimizer.defaults)
        self.state = optimizer.state
        for group in self.param_groups:
            group.setdefault("lookahead_alpha", alpha)
            group.setdefault("lookahead_k", k)
            group.setdefault("lookahead_step", 0)

    def load_state_dict(self, state_dict) -> None:
        self.optimizer.load_state_dict(state_dict)
        self.param_groups = self.optimizer.param_groups
        self.state = self.optimizer.state

    @torch.no_grad()
    def step(self, closure=None):
        # the slow copy starts at the weights before the first step; it
        # joins the state after the wrapped optimizer's first step, which
        # may take an empty state for its own start
        start = {p: p.detach().clone() for g in self.param_groups
                 for p in g["params"] if "lookahead_slow" not in self.state[p]}
        loss = self.optimizer.step(closure)
        for p, slow in start.items():
            self.state[p]["lookahead_slow"] = slow
        for group in self.param_groups:
            group["lookahead_step"] += 1
            params = group["params"]
            if not params or group["lookahead_step"] % group["lookahead_k"]:
                continue
            slows = [self.state[p]["lookahead_slow"] for p in params]
            synced = torch._foreach_sub(params, slows)
            torch._foreach_mul_(synced, group["lookahead_alpha"])
            torch._foreach_add_(synced, slows)
            torch._foreach_copy_(params, synced)
            torch._foreach_copy_(slows, synced)
        return loss


class Ralamb(Optimizer):
    """RAdam with a LARS-style trust ratio a tensor (the reference's
    ralamb.py, Over9000's RAdam + LARS half): b1 0.9, b2 0.999, eps 1e-8;
    the adaptive step from N_sma >= 5 (not > 5). The trust ratio is
    clip(||p||, 0, 10) over the norm of the candidate new weight
    p·(1 - lr·wd) + candidate step (not of the step alone), 1 where either
    norm is 0; weight decay multiplies p by (1 - lr·wd) before the trusted
    step.

    ``f32_lr``: round 1 - lr·wd in float32, as the JAX package does where
    its lr is a float32 schedule value; with ``solver.host_lr`` its lr is a
    hyperparameter in the updates' dtype, so the factor is rounded in the
    parameters' dtype (the two differ only for float64 parameters)."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 f32_lr: bool = True):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      f32_lr=f32_lr))

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
            lr, wd = group["lr"], group["weight_decay"]
            grads = grads_of(params)
            t = count_step(self.state, params, exp_avg=_zeros,
                           exp_avg_sq=_zeros)
            ms = [self.state[p]["exp_avg"] for p in params]
            vs = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, grads, alpha=1.0 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, grads, grads, value=1.0 - b2)

            step_size, adaptive = radam_step_size(t, b1, b2, 5.0,
                                                  inclusive=True)
            if adaptive:
                denom = torch._foreach_sqrt(vs)
                torch._foreach_add_(denom, group["eps"])
                cand = torch._foreach_div(ms, denom)
                torch._foreach_mul_(cand, -step_size * lr)
            else:
                cand = torch._foreach_mul(ms, -step_size * lr)
            keep = float(np.float32(1.0) - np.float32(lr) * np.float32(wd)) \
                if group["f32_lr"] else 1.0 - lr * wd
            p_dec = torch._foreach_mul(params, keep) if wd > 0 else params
            radam_norm = torch.stack(torch._foreach_norm(
                torch._foreach_add(p_dec, cand)))
            weight_norm = torch.stack(torch._foreach_norm(params)).clamp(
                0.0, 10.0)
            trust = torch.where((weight_norm == 0) | (radam_norm == 0),
                                torch.ones_like(weight_norm),
                                weight_norm / radam_norm)
            torch._foreach_mul_(cand, list(trust.unbind()))
            if wd > 0:
                upd = torch._foreach_sub(p_dec, params)
                torch._foreach_add_(upd, cand)
            else:
                upd = cand
            torch._foreach_add_(params, upd)
        return loss
