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


def mat_to_ortho6d(rot: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 6]: the first two columns."""
    return torch.cat([rot[..., :, 0], rot[..., :, 1]], dim=-1)


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


def mat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w,x,y,z), w >= 0: branchless Shepperd's
    method, the construction with the largest pivot (the first of equal
    ones)."""
    m = rot
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    t = m00 + m11 + m22
    d21, d02, d10 = (m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1])
    s01, s02, s12 = (m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1])
    pw, px = 1.0 + t, 1.0 + m00 - m11 - m22
    py, pz = 1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11
    cands = torch.stack([
        torch.stack([pw, d21, d02, d10], -1),
        torch.stack([d21, px, s01, s02], -1),
        torch.stack([d02, s01, py, s12], -1),
        torch.stack([d10, s02, s12, pz], -1),
    ], -1)                          # [..., 4 components, 4 candidates]
    best = torch.stack([pw, px, py, pz], -1).argmax(-1)
    q = torch.take_along_dim(
        cands, best[..., None, None].expand(cands.shape[:-1] + (1,)),
        dim=-1)[..., 0]
    q = normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w,x,y,z) quaternions, broadcasting over batch."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


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


def axangle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """axis [..., 3] (auto-normalized), angle [...] -> [..., 4]."""
    axis = normalize(axis)
    half = angle[..., None] / 2.0
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def log_map(rot: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """SO(3) log: [..., 3, 3] -> axis-angle vector [..., 3], through
    :func:`mat_to_quat` (w >= 0, so the angle is in [0, pi]), which stays
    well conditioned at a half turn."""
    q = mat_to_quat(rot)
    v = q[..., 1:]
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vn[..., 0], q[..., 0])
    return v / vn.clamp_min(eps) * angle[..., None]


def exp_map(vec: torch.Tensor) -> torch.Tensor:
    """SO(3) exp: axis-angle vector [..., 3] -> [..., 3, 3] (the axis via
    the scale-invariant :func:`normalize`)."""
    angle = torch.linalg.vector_norm(vec, dim=-1)
    return axangle_to_mat(normalize(vec), angle)


def euler_to_mat(rx: torch.Tensor, ry: torch.Tensor,
                 rz: torch.Tensor) -> torch.Tensor:
    """Extrinsic XYZ euler angles (radians) -> R = Rz @ Ry @ Rx
    (transforms3d's ``euler2mat(.., axes='sxyz')``)."""
    zero, one = torch.zeros_like(rx), torch.ones_like(rx)
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    shape = rx.shape + (3, 3)
    Rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx],
                     -1).reshape(shape)
    Ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy],
                     -1).reshape(shape)
    Rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one],
                     -1).reshape(shape)
    return Rz @ Ry @ Rx


def angular_distance(r1: torch.Tensor, r2: torch.Tensor,
                     eps: float = 0.0) -> torch.Tensor:
    """Geodesic angle (radians) between rotation matrices [..., 3, 3];
    ``eps=0`` is the exact metric."""
    tr = torch.diagonal(r1.transpose(-1, -2) @ r2, dim1=-2, dim2=-1).sum(-1)
    cos_a = (tr - 1.0) / 2.0
    return torch.arccos(cos_a.clamp(-1.0 + eps, 1.0 - eps))
