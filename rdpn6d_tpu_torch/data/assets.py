"""Per-class model assets: points, extents, FPS keypoints, symmetries.

Counterpart of ``rdpn6d_tpu/data/assets.py`` (``ClassAssets``,
``sample_points``, ``synthetic_class_assets``), with the port's own copies
of the numpy helpers it calls there (``cube_points`` from
``data/synthetic.py``, ``fps_numpy`` from ``ops/fps.py``,
``pad_symmetries``/``pad_sym_trans`` from ``geometry/symmetry.py``).
Loading a BOP dataset's model directory is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
