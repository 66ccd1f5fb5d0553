"""Depth and model-coordinate renders of a triangle mesh, on the host.

Counterpart of ``rdpn6d_tpu/ops/rasterizer.py``: the same ``render_mesh``
over the port's own ``csrc/rasterizer.cpp``, built at first use by
``cuda_build.build_host`` into ``_build/`` and called through ctypes. It
is host C++, not a kernel: VSD renders each pose once a scoring pass on
the host. The build's flags fix the rounding (no FMA contraction), so a
render is the same on every machine.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import cuda_build

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_host("rasterizer")
    lib.render_mesh.argtypes = [_F32P, ctypes.c_int, _I32P, ctypes.c_int,
                                _F32P, _F32P, _F32P, ctypes.c_int,
                                ctypes.c_int, _F32P, _F32P]
    lib.render_mesh.restype = None
    return lib


def render_mesh(verts: np.ndarray, faces: np.ndarray, K: np.ndarray,
                R: np.ndarray, t: np.ndarray, height: int,
                width: int) -> tuple[np.ndarray, np.ndarray]:
    """Render depth [H, W] (camera z, 0 off the mesh) and model-frame xyz
    [H, W, 3] maps of ``verts`` [V, 3] (model frame, metres) and ``faces``
    [F, 3] under K and R [3, 3], t [3]; pixel centres at integer
    coordinates. Everything is rounded to float32 first."""
    lib = _lib()
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"render_mesh: verts [V,3] and faces [F,3], got "
                         f"{v.shape} and {f.shape}")
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError(f"render_mesh: face index out of [0, {len(v)})")
    Kf = np.ascontiguousarray(K, np.float32)
    Rf = np.ascontiguousarray(R, np.float32)
    tf = np.ascontiguousarray(t, np.float32).reshape(3)
    depth = np.zeros((height, width), np.float32)
    xyz = np.zeros((height, width, 3), np.float32)
    lib.render_mesh(v.ctypes.data_as(_F32P), len(v),
                    f.ctypes.data_as(_I32P), len(f),
                    Kf.ctypes.data_as(_F32P), Rf.ctypes.data_as(_F32P),
                    tf.ctypes.data_as(_F32P), int(height), int(width),
                    depth.ctypes.data_as(_F32P), xyz.ctypes.data_as(_F32P))
    return depth, xyz
