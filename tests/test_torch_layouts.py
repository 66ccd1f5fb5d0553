"""The record layouts and frames the port reads since it took MP6D, ITODD
and LineMOD's Blender renders, against the JAX package on one tree:

- ``ycb_style`` records (MP6D: ``-meta.mat`` read with scipy, masks from
  the label image), the gray TIFF frames of ITODD's val scene and its PBR
  frames (PNG and JPEG), and the ``blender`` records (JPEG renders,
  ``_depth_opengl``/``_mask_opengl`` PNGs, ``_xyz_bop.pkl``): every field
  of ``build_split_records`` equal, flat and grouped per image;
- the flat path's per-instance decode, ``RecordDecoder.__call__``, equal
  to the JAX package's with background replacement and truncation on,
  over several visits (the draws come from the per-(record, visit)
  stream on both sides, the backgrounds resized as ``cv2.resize`` does);
- ``register_custom_dataset``'s ref and splits, the image size of a TIFF
  and a JPEG frame from the port's readers where the JAX package asks
  OpenCV.

The trees are ``data/synthetic``'s ``write_mp6d_tree``, ``write_bop_tree``
for itodd (960x1280) and ``write_lm_tree`` + ``write_blender_tree``, read
by both packages. Tolerance: none, every array is equal byte for byte
with its dtype and shape.
"""

import os

import numpy as np
import pytest
import torch

import rdpn6d_tpu.data.refs as jrefs
import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.data import bop as jbop
from rdpn6d_tpu.data import loader as jloader
from rdpn6d_tpu.data.assets import load_class_assets as j_assets
from rdpn6d_tpu.data.custom import register_custom_dataset as j_register
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data import bop as tbop
from rdpn6d_tpu_torch.data import loader as tloader
from rdpn6d_tpu_torch.data.assets import load_class_assets as t_assets
from rdpn6d_tpu_torch.data.custom import register_custom_dataset as t_register
from rdpn6d_tpu_torch.data.synthetic import (
    write_bg_pool,
    write_blender_tree,
    write_bop_tree,
    write_lm_tree,
    write_mp6d_tree,
)
from tests.test_torch_train_data import assert_same

BLENDER_OBJS = {"ape": 1, "can": 5}
OPTS = ["head.num_regions=4", "loss.num_pm_points=64",
        "data.truncate_fg=true"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """mp6d (2 + 2 frames of 4 cubes), itodd (one frame in each of PBR
    scenes 0 and 49, one gray TIFF val frame), LineMOD with its Blender
    renders (2 objects x 2), a background pool, and a two-object blender
    split registered in both packages."""
    root = str(tmp_path_factory.mktemp("layouts"))
    write_mp6d_tree(root, train_frames=2, test_frames=2, seed=3)
    write_bop_tree(root, "itodd", pbr_frames=1, test_frames=1,
                   insts_per_frame=3, seed=4)
    write_lm_tree(root, BLENDER_OBJS, frames_per_obj=2, seed=5)
    write_blender_tree(root, BLENDER_OBJS, frames_per_obj=2, seed=6)
    pool = write_bg_pool(os.path.join(root, "VOC"), seed=7)
    for mod in (jbop, tbop):
        mod.register_split(mod.Split(
            "two_obj_blender_train", "lm_renders_blender", "renders",
            objs=tuple(BLENDER_OBJS), filter_invalid=False))
    return root, pool


@pytest.fixture
def data_root(tree, monkeypatch):
    monkeypatch.setattr(jrefs, "DATA_ROOT", tree[0])
    monkeypatch.setattr(trefs, "DATA_ROOT", tree[0])
    return tree


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("split", [
    "mp6d_train", "mp6d_test", "mp6d_obj_02_train", "itodd_pbr_train",
    "itodd_bop_test", "itodd_pbr_obj_02_test", "two_obj_blender_train",
    "lmo_blender_ape_train"])
def test_records_match_jax(data_root, tmp_path, split, flatten):
    j = jbop.build_split_records(jbop.get_split(split), flatten=flatten)
    t = tbop.build_split_records(tbop.get_split(split),
                                 cache_dir=str(tmp_path), flatten=flatten)
    assert len(t) > 0
    assert_same(t, j, split)
    # the cached copy is what the next call serves
    assert_same(tbop.build_split_records(tbop.get_split(split),
                                         cache_dir=str(tmp_path),
                                         flatten=flatten), j, split)


def test_layouts_read_their_own_files(data_root):
    """mp6d's records carry the label image and the meta.mat's pose in
    metres; itodd's val frames are the gray TIFFs, its PBR frames PNG
    and JPEG (scene 0's first, scene 49's PNG); the blender records the
    JPEG renders and their PNGs."""
    mp6d = tbop.build_split_records(tbop.get_split("mp6d_train"))
    assert all(r["label_path"].endswith("-label.png")
               and r["mask_visib_path"] == "" and r["bbox_visib"] is None
               and 0.5 < r["t"][2] < 1.5 for r in mp6d)
    assert {r["rgb_path"][-4:] for r in tbop.build_split_records(
        tbop.get_split("itodd_bop_test"))} == {".tif"}
    assert {r["rgb_path"][-4:] for r in tbop.build_split_records(
        tbop.get_split("itodd_pbr_train"))} == {".jpg", ".png"}
    blender = tbop.build_split_records(tbop.get_split(
        "two_obj_blender_train"))
    assert len(blender) == 4 and all(
        r["rgb_path"].endswith(".jpg")
        and r["depth_path"].endswith("_depth_opengl.png") for r in blender)


@pytest.mark.parametrize("split", ["mp6d_train", "itodd_bop_test",
                                   "itodd_pbr_train",
                                   "two_obj_blender_train"])
def test_flat_decode_matches_jax_with_background(data_root, split):
    """``RecordDecoder.__call__`` in train mode with background
    replacement at probability 0.7 and truncated foregrounds, visits 0-2
    of up to 3 records (some visits replace, some do not), and in eval
    mode."""
    _, pool = data_root
    ref = jbop.get_split(split).ref_name
    opts = OPTS + ["data.change_bg_prob=0.7", f'data.bg_images_dir="{pool}"']
    recs = tbop.build_split_records(tbop.get_split(split))[:3]
    objs = sorted({jrefs.get_ref(ref).id2obj[r["obj_id"]] for r in recs})
    ja = j_assets(jrefs.get_ref(ref), 4, 64, objs=objs)
    ta = t_assets(trefs.get_ref(ref), 4, 64, objs=objs)
    replaced = 0
    for train in (True, False):
        jd = jloader.RecordDecoder(JConfig().apply_opts(opts), ja,
                                   train=train)
        td = tloader.RecordDecoder(TConfig().apply_opts(opts), ta,
                                   train=train)
        for rec in recs:
            for visit in range(3 if train else 1):
                try:
                    j = jd(rec, visit=visit)
                except jloader.SkipRecord:
                    with pytest.raises(tloader.SkipRecord):
                        td(rec, visit=visit)
                    continue
                t = td(rec, visit=visit)
                assert_same(t, j, f"{rec['rgb_path']}:{visit}")
                replaced += int(not np.array_equal(t["mask_trunc"],
                                                   t["mask_visib"]))
    assert replaced > 0          # the truncating branch ran


def test_register_custom_dataset_matches_jax(data_root):
    """A registration on the itodd tree, train over ``train_pbr`` (its
    first frame a JPEG) and test over ``val``: the same ref and splits as
    the JAX package's; the frame size of a TIFF, a PNG and a JPEG frame
    from the port's readers equals OpenCV's; a tree whose first scene has
    no ``rgb/`` frames (only ``gray/``) is refused by both."""
    from rdpn6d_tpu.data import custom as jcustom
    from rdpn6d_tpu_torch.data import custom as tcustom

    root = os.path.join(data_root[0], "itodd")
    kw = dict(root=root, overwrite=True, test_subdir="val")
    t = t_register("custom_pbr", train_subdir="train_pbr", **kw)
    j = j_register("custom_pbr", train_subdir="train_pbr", **kw)
    assert (t.width, t.height) == (j.width, j.height) == (1280, 960)
    for field in ("name", "id2obj", "diameters_mm", "camera_matrix",
                  "depth_factor", "vertex_scale", "diameters_reliable",
                  "root_override", "layout"):
        assert getattr(t, field) == getattr(j, field), field
    for part in ("train", "test"):
        ts = tbop.get_split(f"custom_pbr_{part}")
        js = jbop.get_split(f"custom_pbr_{part}")
        assert ts.__dict__ == js.__dict__
        assert_same(tbop.build_split_records(ts),
                    jbop.build_split_records(js), f"custom_pbr_{part}")
    for frame in ("val/000001/gray/000000.tif",
                  "train_pbr/000000/rgb/000000.jpg",
                  "train_pbr/000000/depth/000000.png"):
        path = os.path.join(root, frame)
        assert tcustom._image_size(path) == jcustom._png_size(path)
    for register in (t_register, j_register):
        with pytest.raises(ValueError, match="image size not discoverable"):
            register("custom_val", train_subdir="val", **kw)
