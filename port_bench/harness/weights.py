"""The benchmark's seeded weights: one state dict for the program and the
reference alike.

Drawn on the device from one ``torch.Generator`` in one call: a flat
standard normal cut into the tensors. Convolution and linear weights are
LeCun normal (std 1 / sqrt(fan_in)), their biases normal(0, 0.01); norm
weights 1 + normal(0, 0.1) and biases normal(0, 0.1); running means 0 and
variances 1. ``biases`` (the configuration's ``seeded_biases``) sets
named tensors to given values: a head whose outputs a rounding can turn
by a right angle (Gram-Schmidt of two near-parallel columns, a depth
near 0) is given a trained head's offsets. Float32, as the program keeps
its parameters; a serving model casts its copy to its dtype.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_NORMS = (nn.BatchNorm2d, nn.GroupNorm)
_LAYERS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _fan_in(m: nn.Module) -> int:
    if isinstance(m, nn.Linear):
        return m.in_features
    k = m.kernel_size[0] * m.kernel_size[1]
    return m.in_channels * k // m.groups


def seeded_state(model: nn.Module, seed: int, device: torch.device,
                 biases: dict | None = None) -> dict[str, torch.Tensor]:
    """A state dict for ``model``'s keys and shapes from ``seed``."""
    plan = []   # (key, shape, std, mean)
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, _LAYERS):
            plan.append((pre + "weight", m.weight.shape,
                         1.0 / math.sqrt(_fan_in(m)), 0.0))
            if m.bias is not None:
                plan.append((pre + "bias", m.bias.shape, 0.01, 0.0))
        elif isinstance(m, _NORMS):
            plan.append((pre + "weight", m.weight.shape, 0.1, 1.0))
            plan.append((pre + "bias", m.bias.shape, 0.1, 0.0))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    total = sum(math.prod(shape) for _, shape, _, _ in plan)
    flat = torch.randn(total, generator=gen, device=device)
    state = {}
    off = 0
    for key, shape, std, mean in plan:
        n = math.prod(shape)
        state[key] = flat[off:off + n].view(shape) * std + mean
        off += n
    for key, value in model.state_dict().items():
        if key in state:
            continue
        if key.endswith("running_mean"):
            state[key] = torch.zeros(value.shape, device=device)
        elif key.endswith("running_var"):
            state[key] = torch.ones(value.shape, device=device)
        elif key.endswith("num_batches_tracked"):
            state[key] = torch.zeros((), dtype=torch.long, device=device)
        else:
            raise KeyError(f"no seeded value for {key}")
    for key, value in (biases or {}).items():
        state[key] = torch.tensor(value, dtype=torch.float32, device=device)
    return state
