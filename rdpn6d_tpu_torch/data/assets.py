"""Per-class model assets: points, extents, FPS keypoints, symmetries.

Counterpart of ``rdpn6d_tpu/data/assets.py`` (``ClassAssets``,
``sample_points``, ``load_class_assets``, ``synthetic_class_assets``),
with the port's own copies of the numpy helpers it calls there
(``cube_points`` from ``data/synthetic.py``, ``fps_numpy`` and
``get_fps_and_center`` from ``ops/fps.py``, ``pad_symmetries``/
``pad_sym_trans`` from ``geometry/symmetry.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..geometry.symmetry import symmetry_transforms
from .inout import load_ply
from .refs import DatasetRef, _load_models_info


@dataclass
class ClassAssets:
    """Class-major stacked arrays, indexable by class position."""
    obj_ids: list[int]
    points: np.ndarray        # [C, N, 3]
    extents: np.ndarray       # [C, 3]
    fps_points: np.ndarray    # [C, K, 3]
    sym_rots: np.ndarray      # [C, S, 3, 3] identity-padded
    diameters: np.ndarray     # [C]
    sym_trans: np.ndarray | None = None     # [C, S, 3] zero-padded
    # full-dataset class index per row (what class-aware heads were
    # trained with); None = the rows cover the full dataset
    full_cls_idx: list[int] | None = None

    def for_obj(self, obj_id: int) -> dict[str, np.ndarray]:
        i = self.obj_ids.index(obj_id)
        return {"points": self.points[i], "extent": self.extents[i],
                "fps": self.fps_points[i], "sym_rots": self.sym_rots[i],
                "sym_trans": self.sym_trans[i]
                if self.sym_trans is not None
                else np.zeros((self.sym_rots.shape[1], 3), np.float32),
                "diameter": self.diameters[i]}

    def full_idx(self, obj_id: int) -> int:
        """The model's roi_cls for this object (full-dataset index)."""
        i = self.obj_ids.index(obj_id)
        return self.full_cls_idx[i] if self.full_cls_idx is not None else i


def sample_points(pts: np.ndarray, n: int, seed: int = 2021) -> np.ndarray:
    """Deterministic fixed-count subsample (with replacement iff needed)."""
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(pts), n, replace=len(pts) < n)
    return pts[idx]


def cube_points(n_per_edge: int = 5, half: float = 0.05) -> np.ndarray:
    """Vertices sampled on a cube surface, side 2*half (metres)."""
    g = np.linspace(-half, half, n_per_edge)
    pts = []
    for fixed in (-half, half):
        for axis in range(3):
            a, b = np.meshgrid(g, g)
            face = np.stack([a.ravel(), b.ravel(),
                             np.full(a.size, fixed)], -1)
            pts.append(np.roll(face, axis, axis=-1))
    return np.unique(np.concatenate(pts, 0), axis=0).astype(np.float32)


def fps_numpy(points: np.ndarray, num_samples: int) -> np.ndarray:
    """Farthest point sampling indices [num_samples], started from the
    point farthest from the bounding-box center."""
    pts = np.asarray(points, dtype=np.float64)
    center = (pts.max(0) + pts.min(0)) / 2.0
    min_dist = np.sum((pts - center) ** 2, axis=-1)
    cur = int(np.argmax(min_dist))
    idxs = np.empty((num_samples,), dtype=np.int32)
    for i in range(num_samples):
        idxs[i] = cur
        d = np.sum((pts - pts[cur]) ** 2, axis=-1)
        np.minimum(min_dist, d, out=min_dist)
        min_dist[cur] = -np.inf  # never reselect
        cur = int(np.argmax(min_dist))
    return idxs


def _sq_dist_fma(pts: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Squared distances [N] float32 of pts [N,3] float32 to p [3], rounded
    as the JAX package's native FPS kernel computes them: its
    ``dx*dx + dy*dy + dz*dz`` is built (Makefile: -O3 -march=native, on
    an x86-64 with FMA) as fma(dz, dz, fma(dx, dx, dy*dy)). A float32
    product is exact in float64, so each fma is one float64 sum rounded to
    float32 (a double rounding that matters for ~2^-29 of the sums)."""
    d = (pts - p).astype(np.float64)
    dy2 = (d[:, 1] * d[:, 1]).astype(np.float32).astype(np.float64)
    s = (d[:, 0] * d[:, 0] + dy2).astype(np.float32).astype(np.float64)
    return (d[:, 2] * d[:, 2] + s).astype(np.float32)


def fps_float32(points: np.ndarray, num_samples: int) -> np.ndarray:
    """Farthest point sampling indices [num_samples], in float32 as the JAX
    package's default backend (``csrc/fps/fps.cpp``,
    ``farthest_point_sampling_init_center``) runs it: seeded from the
    bounding-box centre, ties to the lowest index, a chosen point never
    chosen again, picks cycled when there are fewer points than samples."""
    pts = np.ascontiguousarray(points, np.float32)
    n = pts.shape[0]
    idxs = np.zeros(num_samples, np.int32)
    if n == 0 or num_samples <= 0:
        return idxs
    center = (pts.min(0) + pts.max(0)) * np.float32(0.5)
    min_dist = _sq_dist_fma(pts, center)
    cur = int(np.argmax(min_dist))
    n_unique = min(num_samples, n)
    lowest = np.float32(-np.finfo(np.float32).max)
    for s in range(n_unique):
        idxs[s] = cur
        min_dist[cur] = lowest
        np.minimum(min_dist, _sq_dist_fma(pts, pts[cur]), out=min_dist)
        cur = int(np.argmax(min_dist))
    idxs[n_unique:] = idxs[np.arange(n_unique, num_samples) % n_unique]
    return idxs


def get_fps_and_center(points: np.ndarray, num_fps: int) -> np.ndarray:
    """FPS keypoints with the mean of the vertices appended,
    [num_fps + 1, 3] float32 (the JAX package's native backend)."""
    pts = np.asarray(points)
    return np.concatenate([pts[fps_float32(pts, num_fps)],
                           np.mean(pts, axis=0, keepdims=True)],
                          axis=0).astype(np.float32)


def pad_symmetries(sym_list: list[np.ndarray | None]) -> np.ndarray:
    """Per-class [K_i, 3, 3] banks (None = asymmetric) -> identity-padded
    [C, K_max, 3, 3] float32."""
    banks = [np.eye(3, dtype=np.float32)[None] if s is None or len(s) == 0
             else np.asarray(s, dtype=np.float32) for s in sym_list]
    K = max(b.shape[0] for b in banks)
    out = np.tile(np.eye(3, dtype=np.float32), (len(banks), K, 1, 1))
    for i, b in enumerate(banks):
        out[i, :b.shape[0]] = b
    return out


def pad_sym_trans(trans_list: list[np.ndarray | None]) -> np.ndarray:
    """Zero-padded companion of :func:`pad_symmetries`: [C, K_max, 3]."""
    banks = [np.zeros((1, 3), np.float32) if t is None or len(t) == 0
             else np.asarray(t, dtype=np.float32) for t in trans_list]
    K = max(b.shape[0] for b in banks)
    out = np.zeros((len(banks), K, 3), np.float32)
    for i, b in enumerate(banks):
        out[i, :b.shape[0]] = b
    return out


def load_class_assets(ref: DatasetRef, num_regions: int = 32,
                      num_pm_points: int = 3000,
                      max_sym_disc_step: float = 0.01,
                      objs: list[str] | None = None,
                      use_eval_models: bool = False) -> ClassAssets:
    """The asset bank of a dataset's model directory: per object the PLY
    mesh (``use_eval_models``: the decimated ``models_eval`` meshes and
    their models_info, what ADD/ADI are scored on), ``num_pm_points``
    sampled points, extents, FPS keypoints (from the precomputed
    ``fps_points.pkl`` when the model directory has it, else computed),
    and the symmetry banks."""
    model_dir = ref.eval_model_dir if use_eval_models else ref.model_dir
    obj_ids = [ref.obj2id[o] for o in (objs or ref.objects)]
    info_path = os.path.join(model_dir, "models_info.json")
    info = _load_models_info(info_path) if os.path.exists(info_path) \
        else ref.models_info()
    try:
        fps_pkl = ref.fps_points(num_regions)
    except (FileNotFoundError, KeyError):
        fps_pkl = None

    pts_l, ext_l, fps_l, sym_l, symt_l, dia_l = [], [], [], [], [], []
    scale = float(ref.vertex_scale)     # models_info is in the mesh's unit
    for oid in obj_ids:
        mi = info[str(oid)]
        ply = load_ply(os.path.join(model_dir, f"obj_{oid:06d}.ply"),
                       vertex_scale=ref.vertex_scale)
        pts = ply["pts"].astype(np.float32)
        pts_l.append(sample_points(pts, num_pm_points))
        ext_l.append(np.array([mi["size_x"], mi["size_y"], mi["size_z"]],
                              np.float32) * scale)
        if fps_pkl is not None and oid in fps_pkl:
            fps = fps_pkl[oid][:num_regions]
        else:
            fps = get_fps_and_center(pts, num_regions)[:-1]
        fps_l.append(fps.astype(np.float32))
        if "symmetries_discrete" in mi or "symmetries_continuous" in mi:
            sym, sym_t = symmetry_transforms(mi, max_sym_disc_step,
                                             trans_scale=scale)
        else:
            sym, sym_t = None, None
        sym_l.append(sym)
        symt_l.append(sym_t)
        dia_l.append(mi.get("diameter", 0.0) * scale)

    return ClassAssets(
        obj_ids=obj_ids,
        full_cls_idx=[ref.obj_ids.index(oid) for oid in obj_ids],
        points=np.stack(pts_l),
        extents=np.stack(ext_l),
        fps_points=np.stack(fps_l),
        sym_rots=pad_symmetries(sym_l),
        sym_trans=pad_sym_trans(symt_l),
        diameters=np.asarray(dia_l, np.float32),
    )


def synthetic_class_assets(num_regions: int = 32,
                           num_pm_points: int = 256) -> ClassAssets:
    """Cube-only asset bank for tests and smoke runs (no dataset on disk)."""
    pts = cube_points()
    fps = pts[fps_numpy(pts, num_regions)]
    return ClassAssets(
        obj_ids=[1],
        points=sample_points(pts, num_pm_points)[None],
        extents=np.array([[0.1, 0.1, 0.1]], np.float32),
        fps_points=fps[None],
        sym_rots=pad_symmetries([None]),
        sym_trans=pad_sym_trans([None]),
        diameters=np.asarray([0.1 * np.sqrt(3)], np.float32),
    )
