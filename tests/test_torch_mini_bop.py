"""``tools.make_mini_bop`` and ``tools.gen_xyz_crop`` against the JAX
package's ``tools/make_mini_bop.py`` and ``tools/gen_xyz_crop.py``, loaded
from their files, on a tree of 2 train and 2 test frames at seed 0.

Each package renders with its own rasterizer build, which may part from
the other in the last bits and, where two triangles meet, pick the other
one (``test_torch_vsd.py``: covered pixels equal on >= 99.9%, depth within
1e-6 relative on >= 99.9% of them). What is held:

  * the models (PLY text), ``models_info.json``, every ``scene_gt`` /
    ``scene_camera`` / ``scene_gt_info`` JSON, the BOP19 targets and the
    detections equal: the draws are the JAX tool's, in its order;
  * the visible masks equal on >= 99.9% of pixels, the 16-bit depth (mm)
    within 1 on every pixel and equal on >= 99.9%, the RGB (albedo by the
    rendered xyz, shaded by the depth gradient, rounded to uint8) within 1
    on >= 99.9% of pixels;
  * the records that each package's ``build_split_records`` builds from its
    own tree equal field by field (paths under the tree's root);
  * the xyz crop pickles: the same files, the same boxes, and xyz (float16)
    within one float16 ulp on >= 99.9% of pixels.
"""

import importlib.util
import json
import os
import pickle
import sys

import cv2
import numpy as np
import pytest
import torch

import rdpn6d_tpu.data.refs as jrefs
import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu.data import bop as jbop
from rdpn6d_tpu_torch.data import bop as tbop
from rdpn6d_tpu_torch.data.png import imread_mask, imread_rgb, \
    imread_unchanged
from rdpn6d_tpu_torch.tools import gen_xyz_crop, make_mini_bop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def jax_tool(name):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    return mod


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("mini_bop")
    j, t = str(base / "jax"), str(base / "port")
    jax_tool("make_mini_bop").make(j, n_train=2, n_test=2, seed=0)
    make_mini_bop.make(t, n_train=2, n_test=2, seed=0)
    return j, t


def files(root):
    out = []
    for dirpath, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(dirpath, n), root)
                for n in names]
    return sorted(out)


def test_tree_json_and_models_match_jax(trees):
    j, t = trees
    assert files(t) == files(j)
    texts = [f for f in files(t) if f.endswith((".json", ".ply"))]
    assert len(texts) == 16
    for f in texts:
        with open(os.path.join(t, f)) as a, open(os.path.join(j, f)) as b:
            if f.endswith(".json"):
                assert json.load(a) == json.load(b), f
            else:
                assert a.read() == b.read(), f
    with open(os.path.join(t, "lm", "detections_mini.json")) as f:
        assert len(json.load(f)) > 0


def test_tree_images_match_jax(trees):
    j, t = trees
    pngs = [f for f in files(t) if f.endswith(".png")]
    kinds = {"mask_visib": 0, "depth": 0, "rgb": 0}
    for f in pngs:
        kind = f.split(os.sep)[-2]
        kinds[kind] += 1
        jp, tp = os.path.join(j, f), os.path.join(t, f)
        if kind == "mask_visib":
            a, b = imread_mask(tp), cv2.imread(jp, cv2.IMREAD_GRAYSCALE)
            assert np.mean(a == b) >= 0.999, f
        elif kind == "depth":
            a = imread_unchanged(tp).astype(np.int64)
            b = cv2.imread(jp, cv2.IMREAD_UNCHANGED).astype(np.int64)
            assert np.abs(a - b).max() <= 1 and np.mean(a == b) >= 0.999, f
            assert (a > 0).any()
        else:
            a = imread_rgb(tp).astype(np.int64)
            b = cv2.cvtColor(cv2.imread(jp), cv2.COLOR_BGR2RGB).astype(
                np.int64)
            assert np.mean(np.abs(a - b).max(-1) <= 1) >= 0.999, f
    assert kinds["depth"] == kinds["rgb"] == 4 and kinds["mask_visib"] >= 8


def _plain(rec, root):
    out = {}
    for k, v in rec.items():
        if isinstance(v, str) and v.startswith(root):
            v = os.path.relpath(v, root)
        out[k] = v
    return out


@pytest.mark.parametrize("split", ["lm_mini_train", "lm_mini_test"])
def test_records_match_jax(trees, split, monkeypatch):
    j, t = trees
    monkeypatch.setattr(jrefs, "DATA_ROOT", j)
    monkeypatch.setattr(trefs, "DATA_ROOT", t)
    jr = jbop.build_split_records(jbop.get_split(split), flatten=True)
    tr = tbop.build_split_records(tbop.get_split(split), flatten=True)
    assert len(tr) == len(jr) > 0
    for a, b in zip(tr, jr):
        a, b = _plain(a, t), _plain(b, j)
        assert set(a) == set(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


def test_xyz_crops_match_jax(trees, monkeypatch):
    j, t = trees
    monkeypatch.setattr(jrefs, "DATA_ROOT", j)
    monkeypatch.setattr(trefs, "DATA_ROOT", t)
    monkeypatch.setattr(sys, "argv", ["gen_xyz_crop", "--split",
                                      "lm_mini_train"])
    jax_tool("gen_xyz_crop").main()
    n = gen_xyz_crop.main(["--split", "lm_mini_train"])
    # a second run keeps what is there; --overwrite writes them again
    assert gen_xyz_crop.main(["--split", "lm_mini_train"]) == 0
    assert gen_xyz_crop.main(["--split", "lm_mini_train",
                              "--overwrite"]) == n
    crops = [f for f in files(t) if f.endswith(".pkl")]
    assert crops == [f for f in files(j) if f.endswith(".pkl")]
    assert len(crops) == n >= 4
    for f in crops:
        with open(os.path.join(t, f), "rb") as a:
            tc = pickle.load(a)
        with open(os.path.join(j, f), "rb") as b:
            jc = pickle.load(b)
        assert tc["xyxy"] == jc["xyxy"], f
        assert tc["xyz_crop"].dtype == jc["xyz_crop"].dtype == np.float16
        x, y = tc["xyz_crop"], jc["xyz_crop"]
        assert x.shape == y.shape
        ulp = np.spacing(np.abs(y).astype(np.float16))
        close = np.abs(x.astype(np.float32) - y.astype(np.float32)) \
            <= ulp.astype(np.float32)
        assert close.all(-1).mean() >= 0.999, f
