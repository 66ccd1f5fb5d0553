"""Rank functions for the port's data-parallel tests
(``tests/test_torch_dist*.py``), run by ``rdpn6d_tpu_torch.parallel.spawn``
in fresh processes. This module imports no ``jax``, so a spawned rank never
loads ``tests/conftest.py``'s JAX set-up; each rank uses one CPU thread.
Every function takes the rank's device first and returns numpy or CPU
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from rdpn6d_tpu_torch.config import Config
from rdpn6d_tpu_torch.models import RDPN
from rdpn6d_tpu_torch.models.norm import BatchNorm2d
from rdpn6d_tpu_torch.parallel import (
    create_train_state,
    make_sharded_train_step,
    make_train_step,
    mesh,
)
from rdpn6d_tpu_torch.solver import build_schedule


def several(device, calls: list[tuple[str, tuple, dict]]) -> list:
    """Each (name of a function of this module, args, kwargs) in turn, in
    one spawn of the ranks."""
    return [globals()[name](device, *args, **kwargs)
            for name, args, kwargs in calls]


def _rows(x: np.ndarray) -> np.ndarray:
    n = x.shape[0] // mesh.world()
    return x[mesh.rank() * n:(mesh.rank() + 1) * n]


def train_steps(device, opts: list[str], state_dict: dict,
                batches: list[dict], total_iters: int,
                dtype: torch.dtype = torch.float32) -> dict:
    """``len(batches)`` train steps from ``state_dict`` on global batches
    (numpy dicts): this rank's rows through ``make_sharded_train_step`` in
    a process group, every row through ``make_train_step`` in none. The
    metrics of each step, the first step's gradients (summed over the
    ranks; clipped where ``solver.max_grad_norm`` is set) and the final
    state dict."""
    torch.set_num_threads(1)
    cfg = Config().apply_opts(opts)
    model = RDPN(cfg).to(dtype)
    model.load_state_dict(state_dict)
    model = mesh.replicate(model.to(device))
    schedule = build_schedule(cfg, total_iters)
    state = create_train_state(cfg, model, lr=schedule(0))
    step = (make_sharded_train_step if mesh.in_group()
            else make_train_step)(cfg, schedule)
    grads, metrics = None, []
    for b in batches:
        local = {k: torch.from_numpy(_rows(v) if mesh.in_group() else v)
                 .to(device) for k, v in b.items()}
        state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
    return {"metrics": metrics, "grads": grads,
            "state": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}}


def batchnorm(device, x: np.ndarray, weight: np.ndarray, bias: np.ndarray,
              grad_out: np.ndarray, autocast: bool) -> dict:
    """One train-mode forward and backward of ``BatchNorm2d`` on this
    rank's rows of ``x`` [B, C, H, W] (all rows in no group), loss
    sum(y * grad_out); under bf16 autocast the input is rounded to bf16,
    as a conv's output is there."""
    torch.set_num_threads(1)
    bn = BatchNorm2d(x.shape[1]).to(device).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_var.fill_(0.5)
    pick = _rows if mesh.in_group() else (lambda a: a)
    xt = torch.from_numpy(pick(x)).to(device)
    if autocast:
        xt = xt.to(torch.bfloat16)
    xt.requires_grad_(True)
    with torch.autocast(torch.device(device).type, dtype=torch.bfloat16,
                        enabled=autocast):
        y = bn(xt)
    (y.float() * torch.from_numpy(pick(grad_out)).to(device)).sum() \
        .backward()
    return {"y": y.detach().float().cpu(), "dx": xt.grad.float().cpu(),
            "dw": bn.weight.grad.cpu(), "db": bn.bias.grad.cpu(),
            "mean": bn.running_mean.cpu(), "var": bn.running_var.cpu(),
            "dtype": str(y.dtype)}


def collectives(device) -> dict:
    """``all_reduce_sum``'s value and gradient, ``gather_predictions`` and
    ``replicate`` across the ranks."""
    torch.set_num_threads(1)
    r = mesh.rank()
    x = torch.full((3,), float(r + 1), requires_grad=True)
    y = mesh.all_reduce_sum(x * (r + 2))
    (y * (r + 1)).sum().backward()
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight.fill_(r)
    mesh.replicate(lin)
    return {"y": y.detach(), "dx": x.grad,
            "gathered": mesh.gather_predictions([f"r{r}a", f"r{r}b"]),
            "weight": lin.weight.detach().clone()}


def run_eval(device, opts: list[str], data_root: str, split,
             ckpt_dir: str, csv_path: str) -> dict:
    """``run_eval`` of the checkpoint in ``ckpt_dir`` on ``split`` (a
    ``data.bop.Split``, registered here) of the tree at ``data_root``,
    float32, this rank's frame shard in a group."""
    from rdpn6d_tpu_torch.data import bop, refs
    from rdpn6d_tpu_torch.engine.eval_runner import run_eval as _run

    torch.set_num_threads(1)
    refs.DATA_ROOT = data_root
    bop.register_split(split)
    cfg = Config().apply_opts(opts)
    out = _run(cfg, ckpt_dir=ckpt_dir, split_name=split.name, device=device,
               dtype=torch.float32, csv_path=csv_path)
    return {k: out[k] for k in ("per_obj", "mean", "stats") if k in out}
