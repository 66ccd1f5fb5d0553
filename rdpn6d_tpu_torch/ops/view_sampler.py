"""Viewpoint sampling on a sphere.

Counterpart of ``rdpn6d_tpu/ops/view_sampler.py`` (the reference's
``lib/pysixd/view_sampler.py``: icosahedron subdivision views for
renderer-based data prep and AAE-style codebooks), copied as numpy: the
recursive icosahedron sampling, a Fibonacci spiral, and the OpenCV-style
look-at rotations.
"""

from __future__ import annotations

import math

import numpy as np


def fibonacci_sphere(n: int, hemisphere: bool = False) -> np.ndarray:
    """n roughly-uniform unit vectors (upper hemisphere if requested)."""
    ga = math.pi * (3.0 - math.sqrt(5.0))
    i = np.arange(n, dtype=np.float64)
    z = 1.0 - 2.0 * (i + 0.5) / n
    if hemisphere:
        z = np.abs(z)
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    th = ga * i
    return np.stack([r * np.cos(th), r * np.sin(th), z], -1)


def icosphere_views(min_views: int, radius: float = 1.0,
                    hemisphere: bool = False) -> np.ndarray:
    """Subdivide an icosahedron until >= min_views vertices; returns unit
    view directions * radius."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)

    # with hemisphere the z>=0 filter keeps roughly half the vertices, so
    # subdivide until the FILTERED count satisfies the contract
    def _n_kept(v):
        return int(np.sum(v[:, 2] >= -1e-9)) if hemisphere else len(v)

    while _n_kept(verts) < min_views:
        edge_mid: dict[tuple[int, int], int] = {}
        new_faces = []
        verts_l = verts.tolist()

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (np.asarray(verts_l[a]) + np.asarray(verts_l[b])) / 2.0
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts_l)
                verts_l.append(m.tolist())
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(verts_l)
        faces = np.asarray(new_faces)

    if hemisphere:
        verts = verts[verts[:, 2] >= -1e-9]
    return verts * radius


def look_at_rotations(view_dirs: np.ndarray,
                      up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera rotation per view direction: camera at dir*r looking at the
    origin. Returns [N, 3, 3] world->camera rotations."""
    ups = np.tile(np.asarray(up, np.float64), (len(view_dirs), 1))
    z = -view_dirs / np.linalg.norm(view_dirs, axis=1, keepdims=True)
    # avoid degenerate up || z
    deg = np.abs(np.sum(ups * z, axis=1)) > 0.99
    ups[deg] = (1.0, 0.0, 0.0)
    # reference/OpenCV convention (view_sampler.py:248-261: gluLookAt
    # rows then the GL->CV y/z flip, net R = [s; cross(f,s); f] with
    # s = cross(f, up)): cross(up, z) here would negate the x AND y rows
    # — every rendered template would be 180-deg in-plane flipped
    x = np.cross(z, ups)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)
