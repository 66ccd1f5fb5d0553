"""Runtime registration of a user's own BOP-layout dataset.

The port's own copy of ``rdpn6d_tpu/data/custom.py``: one call reads a
BOP-layout tree (``models/models_info.json`` for the object ids and
diameters, the first ``scene_camera.json`` for the intrinsics, the first
RGB frame for the image size) and registers a ``DatasetRef`` and its
``{name}_train`` / ``{name}_test`` ``Split`` entries, which the builders of
``data/bop.py`` read as they read the built-in datasets. A config file
that calls ``register_custom_dataset`` at its top wires the dataset into
every entry point, since each loads the config first. The image size of a
PNG frame comes from its header, of a TIFF one from its first directory,
of a JPEG one from the port's decoder (``data/image.py``), never OpenCV.
"""

from __future__ import annotations

import json
import logging
import os
import struct

from . import tif
from .image import image_format, imread_rgb
from .refs import REFS, DatasetRef, _load_models_info, get_ref

__all__ = ["register_custom_dataset"]


def _image_size(path: str) -> tuple[int, int]:
    """(width, height) of an image: a PNG's from its IHDR, a TIFF's from
    its first directory, without decoding pixels; a JPEG's from one decode
    (once a registration)."""
    kind = image_format(path)
    if kind == "png":
        with open(path, "rb") as f:
            head = f.read(24)
        w, h = struct.unpack(">II", head[16:24])   # IHDR is always first
        return int(w), int(h)
    if kind == "tif":
        return tif.image_size(path)
    img = imread_rgb(path)
    return int(img.shape[1]), int(img.shape[0])


def _first_scene(root: str, subdirs: tuple[str, ...]) -> str | None:
    for sub in subdirs:
        base = os.path.join(root, sub)
        if not os.path.isdir(base):
            continue
        for scene in sorted(os.listdir(base)):
            sdir = os.path.join(base, scene)
            if os.path.isfile(os.path.join(sdir, "scene_camera.json")):
                return sdir
    return None


def register_custom_dataset(
    name: str,
    *,
    root: str = "",
    id2obj: dict[int, str] | None = None,
    camera_matrix=None,
    width: int = 0,
    height: int = 0,
    depth_factor: float = 1000.0,
    vertex_scale: float = 0.001,
    train_subdir: str = "train",
    test_subdir: str = "test",
    targets_file: str = "",
    visib_thr: float = 0.0,
    overwrite: bool = False,
) -> DatasetRef:
    """Register dataset ``name`` (BOP directory layout) and its splits.

    Everything not passed explicitly is discovered from the tree:
    object ids and diameters from ``models/models_info.json``, the
    camera matrix from the first ``scene_camera.json``, the image size
    from the first RGB frame.  Splits ``{name}_train`` / ``{name}_test``
    are registered for whichever of ``train_subdir`` / ``test_subdir``
    exist on disk (the test split with ``filter_invalid=False``,
    matching the BOP test protocol of the built-in datasets).
    """
    from . import bop  # deferred: bop imports refs

    if name in REFS and not overwrite:
        raise ValueError(
            f"dataset ref '{name}' already registered; pass overwrite=True")

    # resolve the root exactly like DatasetRef.root would, so discovery
    # and record building read the same tree
    probe = DatasetRef(name=name, id2obj={}, diameters_mm=(),
                       camera_matrix=((0.0,) * 3,) * 3,
                       root_override=root)
    root_dir = probe.root
    if not os.path.isdir(root_dir):
        raise FileNotFoundError(f"custom dataset root not found: {root_dir}")

    # ---- objects + diameters from models_info.json --------------------
    info_path = os.path.join(root_dir, "models", "models_info.json")
    info = _load_models_info(info_path) if os.path.isfile(info_path) \
        else None
    diameters: tuple[float, ...] = ()
    reliable = False
    if id2obj is None or not id2obj:
        if info is None:
            raise FileNotFoundError(
                f"{info_path} missing and no id2obj given — one of the two "
                f"is required to enumerate objects")
        id2obj = {int(k): f"obj_{int(k)}" for k in sorted(info, key=int)}
    if info is not None:
        try:
            diameters = tuple(float(info[str(i)]["diameter"])
                              for i in sorted(id2obj))
            reliable = True
        except KeyError:
            pass
    if not diameters:
        diameters = (0.0,) * len(id2obj)

    # ---- camera + image size from the first scene ---------------------
    scene = _first_scene(root_dir, (train_subdir, test_subdir))
    if camera_matrix is None:
        if scene is None:
            raise FileNotFoundError(
                f"no scene_camera.json under {root_dir}/{{{train_subdir},"
                f"{test_subdir}}} and no camera_matrix given")
        with open(os.path.join(scene, "scene_camera.json")) as f:
            cams = json.load(f)
        K = next(iter(cams.values()))["cam_K"]
        camera_matrix = tuple(tuple(float(v) for v in K[r * 3:r * 3 + 3])
                              for r in range(3))
    if not (width and height) and scene is not None:
        rgb_dir = os.path.join(scene, "rgb")
        if os.path.isdir(rgb_dir):
            frames = sorted(
                fn for fn in os.listdir(rgb_dir)
                if fn.lower().endswith((".png", ".jpg", ".jpeg", ".tif")))
            if frames:
                w_disc, h_disc = _image_size(
                    os.path.join(rgb_dir, frames[0]))
                # a half-specified explicit pair keeps its given value
                width, height = width or w_disc, height or h_disc
    if not (width and height):
        # never guess: a wrong frame size silently corrupts the generated
        # xyz crops (renders at the wrong resolution against the true K)
        # and every ROI coordinate downstream
        raise ValueError(
            f"{name}: image size not discoverable (no rgb/ frames under "
            f"the first scene) — pass width=/height= explicitly")

    ref = DatasetRef(
        name=name,
        id2obj=dict(id2obj),
        diameters_mm=diameters,
        camera_matrix=tuple(tuple(row) for row in camera_matrix),
        width=int(width),
        height=int(height),
        depth_factor=depth_factor,
        vertex_scale=vertex_scale,
        diameters_reliable=reliable,
        root_override=root,
    )
    REFS[name] = ref
    get_ref.cache_clear()  # overwrite=True must not serve a stale ref

    for split_suffix, subdir, is_train in (
            ("train", train_subdir, True), ("test", test_subdir, False)):
        base = os.path.join(root_dir, subdir)
        if not os.path.isdir(base):
            continue
        # scene ids discovered from the numeric scene dirs on disk (the
        # built-in splits pin them; a custom tree just has what it has)
        scene_ids = tuple(sorted(
            int(d) for d in os.listdir(base)
            if d.isdigit() and os.path.isfile(
                os.path.join(base, d, "scene_gt.json"))))
        if not scene_ids:
            logging.getLogger("rdpn6d").warning(
                f"{name}: {base} exists but no scene dir has a "
                f"scene_gt.json — split {name}_{split_suffix} NOT "
                f"registered (GT-less trees are not loadable; BOP "
                f"challenge-style withheld-GT test sets need at least "
                f"scene_gt with object ids)")
            continue
        bop.register_split(bop.Split(
            f"{name}_{split_suffix}", name, subdir,
            scene_ids=scene_ids,
            filter_invalid=is_train,
            visib_thr=visib_thr if is_train else 0.0,
            targets_file="" if is_train else targets_file))
    return ref
