"""BOP-layout scene loaders -> flat per-instance records.

The port's own copy of ``rdpn6d_tpu/data/bop.py``: a split is a ``Split``
dataclass, built into a list of plain dicts by ``build_split_records``
(cached as a pickle keyed by the split and the dataset root), registered
by name in the same default registry. The BOP and ``imgn`` (lm_imgn's
synthetic renders) layouts are ported; the ``ycb_style`` (MP6D) and
``blender`` record builders raise.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
from dataclasses import dataclass

import numpy as np

from .inout import (
    load_bop_targets,
    load_scene_camera,
    load_scene_gt,
    load_scene_gt_info,
)
from .refs import DatasetRef, get_ref

logger = logging.getLogger("rdpn6d.bop")


@dataclass(frozen=True)
class Split:
    """A named dataset split: which scenes of which subdir to load.

    Image selection, most specific wins:
    - ``per_obj_index``: template like ``image_set/{obj}_train.txt`` — one
      index file of bare image ids per object, each over scene
      ``subdir/{obj_id:06d}``, instances restricted to that object
      (the reference's LM protocol, lm_dataset_d2.py:103-130 +
      filter_scene).
    - ``index_file``: single file of ``scene_id/im_id`` lines relative to
      the dataset root (the reference's YCB-V protocol: image_sets/train.txt
      and keyframe.txt, ycbv_d2.py:79-97).
    - otherwise: every image of every scene in ``scene_ids``.
    """
    name: str                      # e.g. "ycbv_train_real"
    ref_name: str                  # key into data.refs.REFS
    subdir: str                    # e.g. "train_real", "test", "train_pbr"
    scene_ids: tuple[int, ...] = ()
    objs: tuple[str, ...] = ()     # subset of objects ("" = all)
    filter_invalid: bool = True
    visib_thr: float = 0.0
    targets_file: str = ""         # BOP19 targets json (test splits)
    index_file: str = ""           # scene/im index (ycbv style)
    per_obj_index: str = ""        # per-object index template (lm style)
    n_per_obj: int = -1            # uniform subsample per object (lm_imgn)


def _scene_dir(ref: DatasetRef, subdir: str, scene_id: int) -> str:
    return os.path.join(ref.root, subdir, f"{scene_id:06d}")


def _rgb_path(sdir: str, im_id: int) -> str:
    for sub, ext in (("rgb", "png"), ("rgb", "jpg"), ("gray", "tif")):
        p = os.path.join(sdir, sub, f"{im_id:06d}.{ext}")
        if os.path.exists(p):
            return p
    return os.path.join(sdir, "rgb", f"{im_id:06d}.png")


def _depth_path(sdir: str, im_id: int) -> str:
    return os.path.join(sdir, "depth", f"{im_id:06d}.png")


def _mask_visib_path(sdir: str, im_id: int, inst_idx: int) -> str:
    return os.path.join(sdir, "mask_visib", f"{im_id:06d}_{inst_idx:06d}.png")


def _xyz_path(ref: DatasetRef, subdir: str, sdir: str, scene_id: int,
              im_id: int, inst_idx: int) -> str:
    """Precomputed NOCS-style GT coordinate crop.

    Three layouts are probed so reference-generated data works unchanged:
    - ours (tools/gen_xyz_crop.py): ``<scene>/xyz_crop/<im>_<inst>.pkl``
    - reference YCB-V (ycbv_d2.py:87,225):
      ``<subdir>/xyz_crop/<scene:06d>/<im>_<inst>-xyz.pkl``
    - reference LM (lm_dataset_d2.py:188, xyz_prefixes at :318):
      ``<subdir>/xyz_crop/<scene:06d>/<im>_<inst>.pkl``
    """
    stem = f"{im_id:06d}_{inst_idx:06d}"
    shared = os.path.join(ref.root, subdir, "xyz_crop", f"{scene_id:06d}")
    candidates = (
        os.path.join(sdir, "xyz_crop", f"{stem}.pkl"),
        os.path.join(shared, f"{stem}-xyz.pkl"),
        os.path.join(shared, f"{stem}.pkl"),
    )
    for c in candidates:
        if os.path.exists(c):
            return c
    return candidates[0]


def _read_index_lines(path: str) -> list[str]:
    with open(path) as f:
        return [ln.strip("\r\n ") for ln in f if ln.strip()]


def _scene_plan(split: Split,
                ref: DatasetRef) -> list[tuple[int, list[int] | None,
                                               set[int] | None]]:
    """(scene_id, selected im_ids or None=all, obj_id filter or None)."""
    if split.per_obj_index:
        objs = split.objs or tuple(ref.objects)
        plan = []
        for obj in objs:
            oid = ref.obj2id[obj]
            idx = os.path.join(ref.root, split.per_obj_index.format(obj=obj))
            im_ids = [int(ln) for ln in _read_index_lines(idx)]
            plan.append((oid, im_ids, {oid}))
        return plan
    if split.index_file:
        idx = os.path.join(ref.root, split.index_file)
        if os.path.exists(idx):
            by_scene: dict[int, list[int]] = {}
            for ln in _read_index_lines(idx):
                scene_s, im_s = ln.split("/")
                by_scene.setdefault(int(scene_s), []).append(int(im_s))
            return [(sid, ims, None)
                    for sid, ims in sorted(by_scene.items())]
        # fall through: trees without image_sets/ use the full scene list
        logger.warning(
            f"{split.name}: declared index_file {idx} is missing — "
            f"falling back to ALL images of scenes {split.scene_ids}; "
            f"results will NOT follow the benchmark protocol")
    return [(sid, None, None) for sid in split.scene_ids]


def _depth_factor(ref: DatasetRef, cam: dict) -> float:
    """Raw-depth divisor giving meters: BOP raw*depth_scale = mm, so the
    factor is 1000/depth_scale (reference ycbv_d2.py:128,
    lm_dataset_d2.py:126) regardless of dataset."""
    if "depth_scale" in cam:
        return 1000.0 / float(cam["depth_scale"])
    return ref.depth_factor


def build_split_records(split: Split, cache_dir: str | None = None,
                        flatten: bool = True) -> list[dict]:
    """Parse scene_gt/scene_camera/scene_gt_info into instance records."""
    ref = get_ref(split.ref_name)
    # the key covers the dataset ROOT too: records bake absolute paths, so
    # a cache written under a different RDPN6D_DATA_ROOT must not be served
    cache_key = hashlib.md5(
        (repr(split) + "\0" + ref.root).encode()).hexdigest()[:12]
    if cache_dir:
        cache_path = os.path.join(
            cache_dir, f"{split.name}_{cache_key}_{int(flatten)}.pkl")
        if os.path.exists(cache_path):
            try:
                with open(cache_path, "rb") as f:
                    return pickle.load(f)
            except (EOFError, pickle.UnpicklingError):
                # multi-host: another process may have been writing this
                # cache (pre-atomic-rename builds) or the file is torn —
                # rebuild rather than crash rank N at startup
                pass

    sel_objs = set(split.objs) if split.objs else set(ref.objects)
    if ref.layout == "imgn":
        records = _build_imgn_records(split, ref, sel_objs)
        if not flatten:
            records = _group_per_image(records)
    elif ref.layout == "bop":
        records = _build_bop_records(split, ref, sel_objs, flatten)
    else:
        raise NotImplementedError(
            f"{split.name}: the {ref.layout!r} record layout is not ported "
            "(ROADMAP queue 1 item 10); the BOP and imgn layouts are")
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        # atomic publish: every process of a multi-host run points at the
        # same output dir, so a reader must never observe a half-written
        # pickle (rank 1 raced rank 0's write and died with EOFError)
        tmp = f"{cache_path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(records, f)
        os.replace(tmp, cache_path)
    return records


_INSTANCE_KEYS = ("obj_id", "cls_idx", "R", "t", "visib_fract",
                  "bbox_visib", "bbox_mode", "mask_visib_path",
                  "label_obj_id", "xyz_path", "inst_idx")


def _group_per_image(flat: list[dict]) -> list[dict]:
    """Flat per-instance records -> per-image records with an
    ``instances`` list (the flatten=False contract for builders that only
    produce flat records)."""
    by_im: dict[tuple[int, int], dict] = {}
    for rec in flat:
        key = (rec["scene_id"], rec["im_id"])
        inst = {k: rec[k] for k in _INSTANCE_KEYS if k in rec}
        if key not in by_im:
            image = {k: v for k, v in rec.items()
                     if k not in _INSTANCE_KEYS}
            image["instances"] = []
            by_im[key] = image
        by_im[key]["instances"].append(inst)
    return list(by_im.values())


def _build_bop_records(split: Split, ref: DatasetRef, sel_objs: set[str],
                       flatten: bool) -> list[dict]:
    sel_ids = {ref.obj2id[o] for o in sel_objs}
    obj_ids_sorted = ref.obj_ids
    records = []
    for scene_id, im_sel, obj_filter in _scene_plan(split, ref):
        sdir = _scene_dir(ref, split.subdir, scene_id)
        if not os.path.isdir(sdir):
            # partial trees are common (subset downloads, fixtures); the
            # ycb_style planner skips missing scene dirs too
            logger.warning(f"{split.name}: scene dir missing, skipping: "
                           f"{sdir}")
            continue
        gt = load_scene_gt(os.path.join(sdir, "scene_gt.json"))
        cams = load_scene_camera(os.path.join(sdir, "scene_camera.json"))
        info_path = os.path.join(sdir, "scene_gt_info.json")
        infos = load_scene_gt_info(info_path) if os.path.exists(info_path) \
            else {}
        scene_ids_sel = sel_ids if obj_filter is None \
            else sel_ids & obj_filter
        im_iter = sorted(gt.items()) if im_sel is None \
            else [(i, gt[i]) for i in im_sel]
        for im_id, insts in im_iter:
            cam = cams[im_id]
            image_rec = {
                "dataset_name": split.name,
                "ref_name": split.ref_name,
                "scene_id": scene_id,
                "im_id": im_id,
                "rgb_path": _rgb_path(sdir, im_id),
                "depth_path": _depth_path(sdir, im_id),
                "depth_factor": _depth_factor(ref, cam),
                "K": cam["K"].astype(np.float32),
                "height": ref.height,
                "width": ref.width,
            }
            inst_recs = []
            for inst_idx, inst in enumerate(insts):
                if inst["obj_id"] not in scene_ids_sel:
                    continue
                info = infos.get(im_id, [{}] * len(insts))[inst_idx] \
                    if infos else {}
                visib = info.get("visib_fract", 1.0)
                if split.filter_invalid and visib < max(split.visib_thr,
                                                        1e-9):
                    continue
                bbox = info.get("bbox_visib", None) or info.get(
                    "bbox_obj", None)
                if split.filter_invalid and bbox is not None \
                        and (bbox[2] <= 1 or bbox[3] <= 1):
                    continue  # degenerate box (lm_dataset_d2.py:160-163)
                rec = {
                    "obj_id": inst["obj_id"],
                    # the position among ALL of the ref's ids, as the JAX
                    # package numbers it: 0..14 for LM, while lm13 has
                    # head.num_classes=13 (ROADMAP queue 3)
                    "cls_idx": obj_ids_sorted.index(inst["obj_id"]),
                    "R": inst["R"].astype(np.float32),
                    "t": inst["t"].astype(np.float32),
                    "visib_fract": visib,
                    "bbox_visib": np.asarray(
                        bbox, np.float32) if bbox is not None else None,
                    "mask_visib_path": _mask_visib_path(sdir, im_id,
                                                        inst_idx),
                    "xyz_path": _xyz_path(ref, split.subdir, sdir, scene_id,
                                          im_id, inst_idx),
                    "inst_idx": inst_idx,
                }
                inst_recs.append(rec)
            if not inst_recs:
                continue
            if flatten:
                for rec in inst_recs:
                    records.append({**image_rec, **rec})
            else:
                records.append({**image_rec, "instances": inst_recs})
    return records


def _build_imgn_records(split: Split, ref: DatasetRef,
                        sel_objs: set[str]) -> list[dict]:
    """ImageNet-composited synthetic LM: per-object index files
    ``image_set/train_{obj}.txt`` whose last token is ``{obj}/{id}``;
    images ``imgn/{obj}/{id}-color.png``; the pose from ``-pose.txt``
    (header row skipped); GT xyz at ``xyz_crop_imgn/{obj}/{id}-xyz.pkl``;
    LineMOD's camera, depth in mm. One instance an image, its mask and box
    derived at decode time (from the xyz crop, else depth > 0)."""
    objs = [o for o in (split.objs or tuple(ref.objects)) if o in sel_objs]
    obj_ids_sorted = ref.obj_ids
    K = ref.K()
    records = []
    for obj in objs:
        idx_path = os.path.join(
            ref.root, split.per_obj_index.format(obj=obj))
        ids = [ln.split()[-1] for ln in _read_index_lines(idx_path)]
        if split.n_per_obj > 0 and len(ids) > split.n_per_obj:
            sel = np.linspace(0, len(ids) - 1, split.n_per_obj,
                              dtype=np.int64)
            ids = [ids[int(i)] for i in sel]
        oid = ref.obj2id[obj]
        for j, im_id in enumerate(ids):
            base = os.path.join(ref.root, "imgn", im_id)
            pose = np.loadtxt(base + "-pose.txt", skiprows=1,
                              dtype=np.float64)
            tail = im_id.split("/")[-1]
            records.append({
                "dataset_name": split.name,
                "ref_name": split.ref_name,
                "scene_id": oid,
                "im_id": int(tail) if tail.isdigit() else j,
                "rgb_path": base + "-color.png",
                "depth_path": base + "-depth.png",
                "depth_factor": 1000.0,
                "K": K.astype(np.float32),
                "height": ref.height,
                "width": ref.width,
                "obj_id": oid,
                # the position among ALL of the ref's ids, as for BOP
                "cls_idx": obj_ids_sorted.index(oid),
                "R": pose[:3, :3].astype(np.float32),
                "t": pose[:3, 3].astype(np.float32),
                "visib_fract": 1.0,
                "bbox_visib": None,
                "mask_visib_path": "",
                "xyz_path": os.path.join(ref.root, "xyz_crop_imgn",
                                         im_id + "-xyz.pkl"),
                "inst_idx": 0,
            })
    return records


# ---------------------------------------------------------------------------
# split registry (counterpart of the SPLITS_* dicts,
# lm_dataset_d2.py:304-580 / ycbv_d2.py / mp6d.py:468-515)
# ---------------------------------------------------------------------------

_SPLITS: dict[str, Split] = {}


def register_split(split: Split) -> None:
    _SPLITS[split.name] = split


def get_split(name: str) -> Split:
    if name not in _SPLITS:
        raise KeyError(f"unknown split {name}; have {sorted(_SPLITS)}")
    return _SPLITS[name]


def available_splits() -> list[str]:
    return sorted(_SPLITS)


def _register_defaults() -> None:
    from .refs import LM13_OBJECTS, LM

    # LM protocol (reference lm_dataset_d2.py:304-360): train/test are
    # per-object index files over the BOP ``test`` scenes — LM has no
    # ``train`` image directory.
    register_split(Split("lm_13_train", "lm", "test", objs=LM13_OBJECTS,
                         per_obj_index="image_set/{obj}_train.txt"))
    # classic LM-13 protocol: the FULL per-object image_set test lists
    # (lm_dataset_d2.py) — BOP19 target filtering would silently shrink
    # the eval set vs the reference tables. (Use lmo_bop_test/ycbv_test
    # for the BOP19-protocol numbers.)
    register_split(Split("lm_13_test", "lm", "test", objs=LM13_OBJECTS,
                         per_obj_index="image_set/{obj}_test.txt",
                         filter_invalid=False))
    # synthetic imgn renders (lm_syn_imgn.py:290-320); flagship LM config
    # trains on lm_13_train + this at 1k images per object
    register_split(Split("lm_imgn_13_train_1k_per_obj", "lm_imgn", "imgn",
                         objs=LM13_OBJECTS, n_per_obj=1000,
                         per_obj_index="image_set/train_{obj}.txt"))
    # mini rehearsal dataset (tools/make_mini_bop.py renders it into the
    # lm tree under reserved scenes 91/92): exercises the FULL on-disk
    # protocol — compute_fps -> gen_xyz_crop -> train -> est-bbox eval ->
    # BOP19 AR — without any real dataset (tools/rehearse_protocol.py)
    register_split(Split("lm_mini_train", "lm", "train", scene_ids=(91,),
                         objs=("ape", "can", "driller")))
    register_split(Split("lm_mini_test", "lm", "test", scene_ids=(92,),
                         objs=("ape", "can", "driller"),
                         filter_invalid=False,
                         targets_file="test_targets_mini.json"))
    # single-object mini splits — the SO-protocol rehearsal (the
    # reference's LM results are per-object models, configs/gdrn/lmSO/);
    # same rendered tree, train/eval restricted to one object (BOP19
    # targets filtered to the split's objects in eval_runner)
    for _obj in ("ape", "can", "driller"):
        register_split(Split(f"lm_mini_{_obj}_train", "lm", "train",
                             scene_ids=(91,), objs=(_obj,)))
        register_split(Split(f"lm_mini_{_obj}_test", "lm", "test",
                             scene_ids=(92,), objs=(_obj,),
                             filter_invalid=False,
                             targets_file="test_targets_mini.json"))
    # blender renders (lm_blender.py:301-340: BB8 training set)
    register_split(Split("lm_blender_13_train", "lm_renders_blender",
                         "renders", objs=LM13_OBJECTS,
                         filter_invalid=False))
    from .refs import LMO as _LMO
    register_split(Split("lmo_blender_train", "lm_renders_blender",
                         "renders", objs=tuple(_LMO.objects),
                         filter_invalid=False))
    register_split(Split("lmo_train", "lmo", "train",
                         scene_ids=(2,)))
    register_split(Split("lmo_bop_test", "lmo", "test", scene_ids=(2,),
                         filter_invalid=False,
                         targets_file="test_targets_bop19.json"))
    register_split(Split("lmo_pbr_train", "lmo", "train_pbr",
                         scene_ids=tuple(range(50))))
    # YCB-V protocol (reference ycbv_d2.py:377-412): image_sets index files;
    # test = the PoseCNN keyframes. Scene lists kept as fallback for trees
    # without image_sets/.
    register_split(Split("ycbv_train_real", "ycbv", "train_real",
                         scene_ids=tuple(i for i in range(92)
                                         if i not in range(48, 60)),
                         index_file="image_sets/train.txt"))
    register_split(Split("ycbv_train_pbr", "ycbv", "train_pbr",
                         scene_ids=tuple(range(50))))
    register_split(Split("ycbv_test", "ycbv", "test",
                         scene_ids=tuple(range(48, 60)),
                         index_file="image_sets/keyframe.txt",
                         filter_invalid=False,
                         targets_file="test_targets_bop19.json"))
    # MP6D protocol (reference mp6d.py:468-480): train/test index files
    # over real scenes + the two flat synthetic dirs (scenes 78/79)
    register_split(Split("mp6d_train", "mp6d", "data",
                         scene_ids=tuple(range(0, 21)),
                         index_file="image_set/train_data_list.txt"))
    register_split(Split("mp6d_test", "mp6d", "data",
                         scene_ids=tuple(range(0, 21)),
                         index_file="image_set/test_data_list.txt",
                         filter_invalid=False))
    register_split(Split("tless_primesense_train", "tless",
                         "train_primesense", scene_ids=tuple(range(1, 31))))
    register_split(Split("tless_bop_test", "tless", "test_primesense",
                         scene_ids=tuple(range(1, 21)),
                         filter_invalid=False,
                         targets_file="test_targets_bop19.json"))
    register_split(Split("itodd_pbr_train", "itodd", "train_pbr",
                         scene_ids=tuple(range(50))))
    # BOP withholds itodd/hb TEST GT; local evaluation uses the val
    # scenes (the test CSV for submission can still be produced from
    # detections without GT)
    register_split(Split("itodd_bop_test", "itodd", "val",
                         scene_ids=(1,), filter_invalid=False))
    register_split(Split("hb_pbr_train", "hb", "train_pbr",
                         scene_ids=tuple(range(50))))
    register_split(Split("hb_bop_test", "hb", "val_primesense",
                         scene_ids=(3, 5, 13), filter_invalid=False))
    register_split(Split("tudl_train_real", "tudl", "train_real",
                         scene_ids=(1, 2, 3)))
    register_split(Split("tudl_bop_test", "tudl", "test",
                         scene_ids=(1, 2, 3), filter_invalid=False,
                         targets_file="test_targets_bop19.json"))
    register_split(Split("icbin_pbr_train", "icbin", "train_pbr",
                         scene_ids=tuple(range(50))))
    register_split(Split("icbin_bop_test", "icbin", "test",
                         scene_ids=(1, 2, 3), filter_invalid=False,
                         targets_file="test_targets_bop19.json"))
    # LM PBR renders (reference lm_pbr.py: BOP train_pbr scenes 0-49 with
    # a shared xyz_crop tree — covered by the layout fallbacks)
    register_split(Split("lm_pbr_train", "lm", "train_pbr",
                         scene_ids=tuple(range(50))))
    # per-object LM "SO" splits (reference lm_dataset_d2.py:438-470:
    # image_set index files over the object's own test scene)
    for obj in LM.objects:
        oid = LM.obj2id[obj]
        register_split(Split(f"lm_{obj}_train", "lm", "test",
                             scene_ids=(oid,), objs=(obj,),
                             per_obj_index="image_set/{obj}_train.txt"))
        register_split(Split(f"lm_{obj}_test", "lm", "test",
                             scene_ids=(oid,), objs=(obj,),
                             filter_invalid=False,
                             per_obj_index="image_set/{obj}_test.txt"))
        register_split(Split(f"lm_imgn_{obj}_train_1k_per_obj", "lm_imgn",
                             "imgn", objs=(obj,), n_per_obj=1000,
                             per_obj_index="image_set/train_{obj}.txt"))
    # per-object YCB-V SO splits (reference ycbv_d2.py:429-478)
    from .refs import YCBV, MP6D

    for obj in YCBV.objects:
        register_split(Split(f"ycbv_{obj}_train_real", "ycbv",
                             "train_real", objs=(obj,),
                             scene_ids=tuple(i for i in range(92)
                                             if i not in range(48, 60)),
                             index_file="image_sets/train.txt"))
        register_split(Split(f"ycbv_{obj}_train_pbr", "ycbv", "train_pbr",
                             objs=(obj,), scene_ids=tuple(range(50))))
        register_split(Split(f"ycbv_{obj}_test", "ycbv", "test",
                             objs=(obj,),
                             scene_ids=tuple(range(48, 60)),
                             index_file="image_sets/keyframe.txt",
                             filter_invalid=False))
    # per-object MP6D SO splits (reference mp6d.py:468-515): the same
    # train/test index lists as the full splits, restricted to one object
    for obj in MP6D.objects:
        register_split(Split(f"mp6d_{obj}_train", "mp6d", "data",
                             objs=(obj,), scene_ids=tuple(range(0, 21)),
                             index_file="image_set/train_data_list.txt"))
        register_split(Split(f"mp6d_{obj}_test", "mp6d", "data",
                             objs=(obj,), scene_ids=tuple(range(0, 21)),
                             index_file="image_set/test_data_list.txt",
                             filter_invalid=False))
    # per-object SO splits for the remaining BOP datasets (reference
    # configs/gdrn/{lmo,tless,tudl,itodd,icbin,hb}SO dataset names:
    # e.g. tless_real_1_train / tless_pbr_1_train, tudl_real_can_train,
    # itodd_pbr_1_{train,test}, hb_pbr_01_bear_{train,test},
    # lm_real_ape_all + lmo_pbr_ape_train + lmo_blender_ape_train)
    for obj in _LMO.objects:
        oid = LM.obj2id[obj]
        # every image of the object's own LM scene (train+test union,
        # lm_dataset_d2.py "lm_real_{obj}_all")
        register_split(Split(f"lm_real_{obj}_all", "lm", "test",
                             scene_ids=(oid,), objs=(obj,)))
        register_split(Split(f"lmo_pbr_{obj}_train", "lmo", "train_pbr",
                             objs=(obj,), scene_ids=tuple(range(50))))
        register_split(Split(f"lmo_blender_{obj}_train",
                             "lm_renders_blender", "renders", objs=(obj,),
                             filter_invalid=False))
    from .refs import TLESS, TUDL, ICBIN, ITODD, HB

    for obj in TLESS.objects:  # real train scene id == object id
        oid = TLESS.obj2id[obj]
        register_split(Split(f"tless_real_{obj}_train", "tless",
                             "train_primesense", objs=(obj,),
                             scene_ids=(oid,)))
        register_split(Split(f"tless_pbr_{obj}_train", "tless",
                             "train_pbr", objs=(obj,),
                             scene_ids=tuple(range(50))))
    for obj in TUDL.objects:  # real train scene id == object id
        oid = TUDL.obj2id[obj]
        register_split(Split(f"tudl_real_{obj}_train", "tudl",
                             "train_real", objs=(obj,), scene_ids=(oid,)))
        register_split(Split(f"tudl_pbr_{obj}_train", "tudl", "train_pbr",
                             objs=(obj,), scene_ids=tuple(range(50))))
    for ds_ref, n_scenes in ((ITODD, 50), (ICBIN, 50), (HB, 50)):
        for obj in ds_ref.objects:
            register_split(Split(f"{ds_ref.name}_pbr_{obj}_train",
                                 ds_ref.name, "train_pbr", objs=(obj,),
                                 scene_ids=tuple(range(n_scenes - 2))))
            # last two pbr scenes held out as the SO validation split
            # (real itodd/hb test GT is withheld on BOP)
            register_split(Split(f"{ds_ref.name}_pbr_{obj}_test",
                                 ds_ref.name, "train_pbr", objs=(obj,),
                                 scene_ids=(n_scenes - 2, n_scenes - 1),
                                 filter_invalid=False))


_register_defaults()


def load_bop19_targets(ref: DatasetRef, targets_file: str) -> list[dict]:
    return load_bop_targets(os.path.join(ref.root, targets_file))
