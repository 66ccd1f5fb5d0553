"""Per-dataset constants registry.

The port's own copy of ``rdpn6d_tpu/data/refs/__init__.py``: object id
maps, diameters, camera intrinsics, depth factors and the BOP directory
layout as declarative ``DatasetRef`` dataclasses. The dataset root is
resolved at call time from ``DATA_ROOT`` (tests monkeypatch it) or the
``RDPN6D_DATA_ROOT`` environment variable.
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any

import numpy as np

# In-process override (tests monkeypatch this); None -> env at CALL time.
DATA_ROOT: str | None = None


def data_root() -> str:
    """Dataset root, resolved at CALL time: tests monkeypatch
    ``RDPN6D_DATA_ROOT`` (or ``DATA_ROOT`` above) after this module is
    already imported, so an import-time binding would silently serve
    the previous root."""
    return DATA_ROOT or os.environ.get("RDPN6D_DATA_ROOT",
                                       "datasets/BOP_DATASETS")

_MODELS_INFO_CACHE: dict[tuple[str, float], dict] = {}


def _load_models_info(path: str) -> dict:
    """models_info.json, cached by (path, mtime)."""
    key = (path, os.stat(path).st_mtime)
    if key not in _MODELS_INFO_CACHE:
        with open(path) as f:
            _MODELS_INFO_CACHE[key] = json.load(f)
    return _MODELS_INFO_CACHE[key]


@dataclass(frozen=True)
class DatasetRef:
    name: str
    id2obj: dict[int, str]
    diameters_mm: tuple[float, ...]          # indexed like sorted obj ids
    camera_matrix: tuple[tuple[float, ...], ...]
    width: int = 640
    height: int = 480
    depth_factor: float = 1000.0
    vertex_scale: float = 0.001              # PLY mm -> m
    model_subdir: str = "models"
    eval_model_subdir: str = "models_eval"
    layout: str = "bop"                      # bop | ycb_style (mp6d) | imgn
    model_ref: str = ""                      # borrow models from another ref
    diameters_reliable: bool = True          # False -> require models_info
    extra_cameras: dict[str, tuple[tuple[float, ...], ...]] = field(
        default_factory=dict)
    root_override: str = ""                  # custom datasets living outside
                                             # DATA_ROOT (data/custom.py)

    # ------------------------------------------------------------------
    @property
    def objects(self) -> list[str]:
        return [self.id2obj[i] for i in sorted(self.id2obj)]

    @property
    def obj2id(self) -> dict[str, int]:
        return {v: k for k, v in self.id2obj.items()}

    @property
    def obj_ids(self) -> list[int]:
        return sorted(self.id2obj)

    @property
    def root(self) -> str:
        return self.root_override or os.path.join(data_root(), self.name)

    @property
    def model_dir(self) -> str:
        if self.model_ref:  # e.g. lm_imgn borrows BOP lm meshes
            return get_ref(self.model_ref).model_dir
        return os.path.join(self.root, self.model_subdir)

    @property
    def eval_model_dir(self) -> str:
        """Decimated eval meshes (reference model_eval_dir, ref/ycbv.py);
        falls back to the train meshes when models_eval/ is absent."""
        if self.model_ref:
            return get_ref(self.model_ref).eval_model_dir
        d = os.path.join(self.root, self.eval_model_subdir)
        return d if os.path.isdir(d) else self.model_dir

    def model_path(self, obj_id: int) -> str:
        return os.path.join(self.model_dir, f"obj_{obj_id:06d}.ply")

    def K(self) -> np.ndarray:
        return np.asarray(self.camera_matrix, np.float32)

    def diameter_m(self, obj_id: int) -> float:
        """Object diameter in meters; prefers models_info.json on disk,
        falls back to the static table. Refs whose static table is a
        placeholder (diameters_reliable=False) refuse to guess."""
        try:
            info = self.models_info()
            # models_info is in the mesh's native unit (mm for BOP);
            # vertex_scale converts to meters for custom datasets too
            return float(info[str(obj_id)]["diameter"]) * self.vertex_scale
        except (FileNotFoundError, KeyError):
            if not self.diameters_reliable:
                raise RuntimeError(
                    f"{self.name}: no models_info.json and the built-in "
                    f"diameter table is a placeholder; provide "
                    f"{self.model_dir}/models_info.json")
            return self.diameters_mm[self.obj_ids.index(obj_id)] \
                * self.vertex_scale

    # asset accessors ---------------------------------------------------
    def models_info(self) -> dict[str, Any]:
        return _load_models_info(os.path.join(self.model_dir,
                                              "models_info.json"))

    def fps_points(self, num_fps: int = 32,
                   with_center: bool = False) -> dict[int, np.ndarray]:
        """Precomputed FPS keypoints (tools/compute_fps.py); {obj_id: [K,3]}.

        Mirrors ref/ycbv.py:get_fps_points: a pickle keyed by str obj id with
        per-count entries ``fps{n}_and_center``.
        """
        path = os.path.join(self.model_dir, "fps_points.pkl")
        with open(path, "rb") as f:
            raw = pickle.load(f)
        key = f"fps{num_fps}_and_center"
        out = {}
        for obj_id in self.obj_ids:
            pts = np.asarray(raw[str(obj_id)][key], np.float32)
            out[obj_id] = pts if with_center else pts[:-1]
        return out


LM = DatasetRef(
    name="lm",
    id2obj={1: "ape", 2: "benchvise", 3: "bowl", 4: "camera", 5: "can",
            6: "cat", 7: "cup", 8: "driller", 9: "duck", 10: "eggbox",
            11: "glue", 12: "holepuncher", 13: "iron", 14: "lamp",
            15: "phone"},
    diameters_mm=(102.099, 247.506, 167.355, 172.492, 201.404, 154.546,
                  124.264, 261.472, 108.999, 164.628, 175.889, 145.543,
                  278.078, 282.601, 212.358),
    camera_matrix=((572.4114, 0.0, 325.2611), (0.0, 573.57043, 242.04899),
                   (0.0, 0.0, 1.0)),
)

# the 13 objects used by the lm13 benchmark (no bowl/cup)
LM13_OBJECTS = tuple(o for o in LM.objects if o not in ("bowl", "cup"))

LMO = DatasetRef(
    name="lmo",
    id2obj={1: "ape", 5: "can", 6: "cat", 8: "driller", 9: "duck",
            10: "eggbox", 11: "glue", 12: "holepuncher"},
    diameters_mm=(102.099, 201.404, 154.546, 261.472, 108.999, 164.628,
                  175.889, 145.543),
    camera_matrix=((572.4114, 0.0, 325.2611), (0.0, 573.57043, 242.04899),
                   (0.0, 0.0, 1.0)),
)

YCBV = DatasetRef(
    name="ycbv",
    id2obj={1: "002_master_chef_can", 2: "003_cracker_box",
            3: "004_sugar_box", 4: "005_tomato_soup_can",
            5: "006_mustard_bottle", 6: "007_tuna_fish_can",
            7: "008_pudding_box", 8: "009_gelatin_box",
            9: "010_potted_meat_can", 10: "011_banana",
            11: "019_pitcher_base", 12: "021_bleach_cleanser",
            13: "024_bowl", 14: "025_mug", 15: "035_power_drill",
            16: "036_wood_block", 17: "037_scissors",
            18: "040_large_marker", 19: "051_large_clamp",
            20: "052_extra_large_clamp", 21: "061_foam_brick"},
    diameters_mm=(172.063, 269.573, 198.377, 120.543, 196.463, 89.797,
                  142.543, 114.053, 129.540, 197.796, 259.534, 259.566,
                  161.922, 124.990, 226.170, 237.299, 203.973, 121.365,
                  174.746, 217.094, 102.903),
    camera_matrix=((1066.778, 0.0, 312.9869), (0.0, 1067.487, 241.3109),
                   (0.0, 0.0, 1.0)),
    depth_factor=10000.0,
    extra_cameras={"cmu": ((1077.836, 0.0, 323.7872),
                           (0.0, 1078.189, 279.6921), (0.0, 0.0, 1.0))},
)

MP6D = DatasetRef(
    name="mp6d",
    id2obj={i: f"obj_{i:02d}" for i in range(1, 21)},
    diameters_mm=(110.729, 138.551, 64.319, 70.368, 78.980, 118.470,
                  117.605, 112.676, 99.724, 78.401, 96.479, 90.00, 115.361,
                  109.368, 88.965, 74.81, 149.632, 147.263, 137.073,
                  130.390),
    camera_matrix=((567.53720406, 0.0, 312.66570357),
                   (0.0, 569.36175922, 257.1729701), (0.0, 0.0, 1.0)),
    layout="ycb_style",
)

TLESS = DatasetRef(
    name="tless",
    id2obj={i: f"obj_{i:02d}" for i in range(1, 31)},
    diameters_mm=(63.4175, 66.1226, 67.8287, 76.9545, 95.7124, 108.6549,
                  114.9807, 116.2951, 97.1859, 84.3098, 73.6734, 68.46,
                  70.8918, 73.0923, 81.9944, 77.2959, 104.8408, 108.1586,
                  98.8887, 76.0427, 107.1825, 90.0755, 72.4262, 101.8463,
                  86.5974, 78.1688, 69.9854, 83.4554, 96.2556, 78.4828),
    camera_matrix=((1075.65091572, 0.0, 360.0), (0.0, 1073.90347929, 270.0),
                   (0.0, 0.0, 1.0)),
    width=720, height=540,
)

ITODD = DatasetRef(
    name="itodd",
    id2obj={i: f"obj_{i:02d}" for i in range(1, 29)},
    # dataset constants, ref/itodd_full.py:40-73 (mm)
    diameters_mm=(64.0944, 51.4741, 142.15, 139.379, 158.583, 85.3086,
                  38.5388, 68.884, 94.8011, 55.7152, 140.121, 107.703,
                  128.059, 102.883, 114.191, 193.148, 77.7869, 108.482,
                  121.383, 122.019, 171.23, 267.47, 56.9323, 65.0,
                  48.5103, 66.8026, 55.7315, 24.0832),
    camera_matrix=((2992.63, 0.0, 633.886), (0.0, 3003.985, 489.554),
                   (0.0, 0.0, 1.0)),
    width=1280, height=960,
)

HB = DatasetRef(
    name="hb",
    id2obj={i: f"obj_{i:02d}" for i in range(1, 34)},
    # dataset constants, ref/hb_full.py:74-83 (mm)
    diameters_mm=(232.572, 257.407, 166.500, 179.029, 205.401, 121.408,
                  263.718, 186.813, 166.572, 180.804, 238.514, 156.887,
                  145.339, 243.733, 113.032, 101.588, 132.771, 211.134,
                  185.582, 244.828, 212.603, 190.203, 233.857, 252.263,
                  202.905, 183.794, 264.442, 477.464, 198.004, 416.202,
                  157.985, 201.759, 187.233),
    camera_matrix=((537.4799, 0.0, 318.8965), (0.0, 536.1447, 238.3781),
                   (0.0, 0.0, 1.0)),
)

TUDL = DatasetRef(
    name="tudl",
    id2obj={1: "dragon", 2: "frog", 3: "can"},
    diameters_mm=(430.31, 205.84, 114.9),
    camera_matrix=((515.0, 0.0, 321.566), (0.0, 515.0, 214.08),
                   (0.0, 0.0, 1.0)),
)

ICBIN = DatasetRef(
    name="icbin",
    id2obj={1: "coffee_cup", 2: "juice_carton"},
    diameters_mm=(116.275, 142.543),
    camera_matrix=((550.0, 0.0, 316.0), (0.0, 540.0, 244.0),
                   (0.0, 0.0, 1.0)),
)

# ImageNet-composited synthetic LM renders (reference lm_syn_imgn.py:
# datasets/lm_imgn/{imgn,image_set,xyz_crop_imgn}, LM camera, depth in mm,
# meshes borrowed from BOP lm). Lives at DATA_ROOT/lm_imgn (the reference
# keeps it beside, not inside, BOP_DATASETS — point RDPN6D_DATA_ROOT or a
# symlink accordingly).
LM_IMGN = DatasetRef(
    name="lm_imgn",
    id2obj=LM.id2obj,
    diameters_mm=LM.diameters_mm,
    camera_matrix=LM.camera_matrix,
    layout="imgn",
    model_ref="lm",
)

# Blender-rendered synthetic LM (reference lm_blender.py: the BB8 training
# renders at datasets/lm_renders_blender/renders/{obj}/..., LM camera,
# depth in mm, meshes borrowed from BOP lm).
LM_BLENDER = DatasetRef(
    name="lm_renders_blender",
    id2obj=LM.id2obj,
    diameters_mm=LM.diameters_mm,
    camera_matrix=LM.camera_matrix,
    layout="blender",
    model_ref="lm",
)

REFS: dict[str, DatasetRef] = {
    r.name: r for r in (LM, LMO, YCBV, MP6D, TLESS, ITODD, HB, TUDL, ICBIN,
                        LM_IMGN, LM_BLENDER)
}


@lru_cache(maxsize=None)
def get_ref(name: str) -> DatasetRef:
    if name not in REFS:
        raise KeyError(f"unknown dataset ref: {name}; have {sorted(REFS)}")
    return REFS[name]
