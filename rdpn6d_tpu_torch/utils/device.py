"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    one. A CUDA device on a machine without one raises — the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        asked = "the default" if device is None else "requested"
        raise RuntimeError(
            f"device {str(dev)!r} ({asked}) but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
