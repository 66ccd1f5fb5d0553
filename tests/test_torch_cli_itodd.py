"""ITODD through the port's CLI on the CPU: ``configs/itodd.py`` at tiny
widths on a ``write_bop_tree`` itodd tree (960x1280 frames: PBR training
frames as PNG and JPEG, the val scene's gray TIFF frames), and
``configs/so.py:itodd/<obj>`` (PBR scene 49 its validation split).

What it holds: the config trains on 960x1280 PBR frames (labels from the
depth surface, ``surface_labels``) and scores the val scene read from the
gray TIFFs, the eval preprocessing 960x1280 frames; the port's
``run_eval`` on ``itodd_bop_test`` equals the JAX package's on the same
tree and weights, the JAX side reading the TIFFs with OpenCV
(``test_torch_cli_bop.py``'s tolerance: R and t within 1e-4, the tables
equal); the SO variant trains and scores one object.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import rdpn6d_tpu.data.refs as jrefs
import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu_torch.config import load_config
from rdpn6d_tpu_torch.data.synthetic import write_bg_pool, write_bop_tree
from tests.test_torch_cli_bop import (
    OPTS,
    both_evals,
    carried_weights,
    config_path,
    jax_config,
    record_evals,
    train,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """2 frames in each of PBR scenes 0 and 49 (the first a JPEG), 2 gray
    TIFF val frames, 3 cubes and a mostly hidden fourth a frame; a pool."""
    root = str(tmp_path_factory.mktemp("itodd_cli"))
    write_bop_tree(root, "itodd", pbr_frames=2, test_frames=2,
                   insts_per_frame=3, seed=3)
    return root, write_bg_pool(os.path.join(root, "VOC"), seed=4)


@pytest.fixture
def data_root(tree, monkeypatch):
    monkeypatch.setattr(trefs, "DATA_ROOT", tree[0])
    monkeypatch.setattr(jrefs, "DATA_ROOT", tree[0])
    return tree


def test_cli_trains_and_scores_itodd(data_root, tmp_path, monkeypatch):
    from rdpn6d_tpu_torch.data import image, pipeline

    _, pool = data_root
    sizes, formats, labels = set(), [], []
    pre = pipeline.preprocess_rois_grouped
    read = image.imread_rgb
    surface = pipeline.surface_labels

    def size_spy(cfg, frames, rois, *a, **kw):
        sizes.add(tuple(frames["rgb"].shape[1:3]))
        return pre(cfg, frames, rois, *a, **kw)

    def read_spy(path):
        formats.append(image.image_format(path))
        return read(path)

    def surface_spy(*a, **kw):
        labels.append(1)
        return surface(*a, **kw)

    monkeypatch.setattr(pipeline, "preprocess_rois_grouped", size_spy)
    monkeypatch.setattr(image, "imread_rgb", read_spy)
    from rdpn6d_tpu_torch.data import loader

    monkeypatch.setattr(loader, "imread_rgb", read_spy)
    monkeypatch.setattr(pipeline, "surface_labels", surface_spy)
    results = record_evals(monkeypatch)
    out = str(tmp_path / "itodd")
    state = train(config_path("itodd"), out, pool, "train.eval_period=4")
    # 2 PBR scenes x 2 frames x 4 instances at 4 ROIs a step
    assert state.step == 4 and len(labels) == state.step
    assert sizes == {(960, 1280)}
    assert {"tif", "png", "jpeg"} <= set(formats)
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert (cfg["head"]["num_classes"], cfg["loss"]["pm_loss_sym"]) == (
        28, True)
    (res,) = results
    assert res["stats"]["n_rois"] > 0
    for k in ("ad_10", "adi_10", "AUCad"):
        assert np.isfinite(res["mean"][k]), k
    assert os.path.exists(os.path.join(out, "itodd_bop_test_bop19.csv"))


def test_run_eval_itodd_matches_jax(data_root, tmp_path):
    opts = OPTS + [f'train.output_dir="{tmp_path}"']
    jcfg = jax_config("itodd", opts)
    tcfg = load_config(config_path("itodd"), opts)
    state, ckpt = carried_weights(jcfg, tcfg, str(tmp_path))
    j, t = both_evals(jcfg, tcfg, "itodd_bop_test", ckpt, state,
                      str(tmp_path))
    assert t["stats"]["n_rois"] == j["stats"]["n_rois"] > 0
    assert "bop19" not in t and "bop19" not in j    # no targets file


def test_cli_trains_an_so_variant(data_root, tmp_path, monkeypatch):
    _, pool = data_root
    results = record_evals(monkeypatch)
    out = str(tmp_path / "so")
    state = train(config_path("so") + ":itodd/obj_02", out, pool,
                  "solver.ims_per_batch=2", "train.eval_period=1")
    assert state.step >= 1
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert (cfg["head"]["num_classes"], cfg["data"]["train_datasets"],
            cfg["data"]["test_datasets"]) == (
        1, ["itodd_pbr_obj_02_train"], ["itodd_pbr_obj_02_test"])
    assert all(set(r["per_obj"]) == {"obj_02"} for r in results)
