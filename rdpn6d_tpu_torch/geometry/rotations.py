"""Rotation representations, batch-first over leading dims.

Counterpart of ``rdpn6d_tpu/geometry/rotations.py``. Conventions:
quaternions are (w, x, y, z), not necessarily normalized on input; ortho6d
is the first two COLUMNS of the rotation matrix, [R[:,0]; R[:,1]].
"""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1,
              eps: float = 1e-12) -> torch.Tensor:
    """Scale-invariant L2 normalization (exact zero maps to zero).

    Divides by max|component| before taking the norm: tiny-init heads emit
    raw rotation parameters down at 1e-10..1e-20, where a direct f32 norm
    underflows and an eps clamp returns a visibly non-unit vector."""
    m = v.abs().amax(dim=dim, keepdim=True)
    vs = v / m.clamp_min(eps)
    return vs / torch.linalg.vector_norm(vs, dim=dim,
                                         keepdim=True).clamp_min(eps)


def ortho6d_to_mat(o6d: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] via Gram-Schmidt on the two encoded columns."""
    x_raw, y_raw = o6d[..., 0:3], o6d[..., 3:6]
    x = normalize(x_raw)
    z = normalize(torch.linalg.cross(x, y_raw, dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)  # columns


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z), auto-normalized -> [..., 3, 3]."""
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def axangle_to_mat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula. axis [..., 3] (auto-normalized), angle [...]."""
    axis = normalize(axis)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c = torch.cos(angle)
    s = torch.sin(angle)
    C = 1.0 - c
    m = torch.stack([
        x * x * C + c, x * y * C - z * s, x * z * C + y * s,
        y * x * C + z * s, y * y * C + c, y * z * C - x * s,
        z * x * C - y * s, z * y * C + x * s, z * z * C + c,
    ], dim=-1)
    return m.reshape(angle.shape + (3, 3))


def exp_map(vec: torch.Tensor) -> torch.Tensor:
    """SO(3) exp: axis-angle vector [..., 3] -> [..., 3, 3] (the axis via
    the scale-invariant :func:`normalize`)."""
    angle = torch.linalg.vector_norm(vec, dim=-1)
    return axangle_to_mat(normalize(vec), angle)


def angular_distance(r1: torch.Tensor, r2: torch.Tensor,
                     eps: float = 0.0) -> torch.Tensor:
    """Geodesic angle (radians) between rotation matrices [..., 3, 3];
    ``eps=0`` is the exact metric."""
    tr = torch.diagonal(r1.transpose(-1, -2) @ r2, dim1=-2, dim2=-1).sum(-1)
    cos_a = (tr - 1.0) / 2.0
    return torch.arccos(cos_a.clamp(-1.0 + eps, 1.0 - eps))
