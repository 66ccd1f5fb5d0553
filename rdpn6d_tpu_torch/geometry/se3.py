"""SE(3) helpers: point transforms, pose composition and inversion.

Counterpart of ``rdpn6d_tpu/geometry/se3.py``; ``transform_pts`` is the
one in ``camera.py``.
"""

from __future__ import annotations

import torch

from .camera import transform_pts

__all__ = ["transform_pts", "compose", "invert", "to_homo"]


def compose(Ra: torch.Tensor, ta: torch.Tensor, Rb: torch.Tensor,
            tb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Ra, ta) o (Rb, tb): first apply b, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def invert(R: torch.Tensor, t: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def to_homo(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack [..., 3, 3] + [..., 3] into [..., 4, 4]."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)
