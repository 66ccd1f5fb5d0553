"""Object symmetries: discretized symmetry banks (numpy) and the closest
symmetry-equivalent GT rotation (torch).

Counterpart of ``rdpn6d_tpu/geometry/symmetry.py``: ``symmetry_transforms``
and ``symmetry_rotations`` build a model's bank on the host, as the BOP
toolkit's ``misc.get_symmetry_transformations`` does; ``closest_rot`` picks,
per sample, the bank member nearest the estimate, over an identity-padded
``[..., S, 3, 3]`` bank, so the symmetric point-matching loss needs no host
loop. The padding helpers live in ``data/assets.py``.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from .rotations import angular_distance


def symmetry_transforms(model_info: dict[str, Any],
                        max_sym_disc_step: float = 0.01,
                        trans_scale: float = 1e-3
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Discrete + discretized-continuous symmetry transforms of one model.

    ``model_info`` has BOP's ``models_info.json`` keys:
    ``symmetries_discrete`` (flattened row-major 4x4, translation in the
    mesh's unit, scaled to metres by ``trans_scale``) and
    ``symmetries_continuous`` ({axis, offset}). Returns (rots [S,3,3],
    trans [S,3]) float32, identity first."""
    disc = [(np.eye(3, dtype=np.float64), np.zeros(3))]
    for sym in model_info.get("symmetries_discrete", []):
        m = np.reshape(np.asarray(sym, dtype=np.float64), (4, 4))
        disc.append((m[:3, :3], m[:3, 3] * trans_scale))

    cont = []
    for sym in model_info.get("symmetries_continuous", []):
        axis = np.asarray(sym["axis"], dtype=np.float64)
        axis = axis / np.linalg.norm(axis)
        offset = np.asarray(sym.get("offset", (0, 0, 0)),
                            dtype=np.float64).reshape(3) * trans_scale
        n_steps = int(math.ceil(math.pi / max_sym_disc_step))
        step = 2.0 * math.pi / n_steps
        for i in range(1, n_steps):
            a = i * step
            c, s = math.cos(a), math.sin(a)
            C = 1.0 - c
            x, y, z = axis
            R = np.array([
                [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
                [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
                [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
            ])
            cont.append((R, -R @ offset + offset))

    if cont:
        out = [(Rc @ Rd, Rc @ td + tc)
               for Rd, td in disc
               for Rc, tc in [(np.eye(3), np.zeros(3))] + cont]
    else:
        out = disc
    rots = np.stack([r for r, _ in out]).astype(np.float32)
    trans = np.stack([t for _, t in out]).astype(np.float32)
    return rots, trans


def symmetry_rotations(model_info: dict[str, Any],
                       max_sym_disc_step: float = 0.01) -> np.ndarray:
    """The rotation parts only: what the PM loss consumes."""
    return symmetry_transforms(model_info, max_sym_disc_step)[0]


def closest_rot(rot_est: torch.Tensor, rot_gt: torch.Tensor,
                sym_rots: torch.Tensor) -> torch.Tensor:
    """rot_gt @ sym_rots[k*], with k* the bank member geodesically nearest
    rot_est (ties to the lowest index). rot_est/rot_gt [..., 3, 3];
    sym_rots [..., S, 3, 3] identity-padded -> [..., 3, 3]."""
    cands = rot_gt[..., None, :, :] @ sym_rots            # [..., S, 3, 3]
    d = angular_distance(rot_est[..., None, :, :], cands)  # [..., S]
    best = d.argmin(dim=-1)
    idx = best[..., None, None, None].expand(best.shape + (1, 3, 3))
    return torch.gather(cands, -3, idx)[..., 0, :, :]
