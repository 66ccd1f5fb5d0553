"""MP6D through the port's CLI on the CPU: ``configs/mp6d.py`` at tiny
widths on a ``write_mp6d_tree`` tree (the ``ycb_style`` layout: PNG
frames, label images, ``-meta.mat`` poses, no xyz crops), and
``configs/so.py:mp6d/<obj>``.

What it holds: the config trains from ``ycb_style`` records (its labels
from the depth surface under the label image's masks, ``surface_labels``,
since the tree has no xyz crops) with background replacement and
truncation, and scores ``mp6d_test`` with its ADD(-S) AUC columns; the
port's ``run_eval`` on ``mp6d_test`` equals the JAX package's on the same
tree and weights (``test_torch_cli_bop.py``'s tolerance: R and t within
1e-4, the tables equal); the SO variant trains one object and scores it.
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
from rdpn6d_tpu_torch.data.synthetic import write_bg_pool, write_mp6d_tree
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
    """2 train and 2 test frames of 4 occluding cubes, and a pool."""
    root = str(tmp_path_factory.mktemp("mp6d_cli"))
    write_mp6d_tree(root, train_frames=2, test_frames=2, seed=2)
    return root, write_bg_pool(os.path.join(root, "VOC"), seed=4)


@pytest.fixture
def data_root(tree, monkeypatch):
    monkeypatch.setattr(trefs, "DATA_ROOT", tree[0])
    monkeypatch.setattr(jrefs, "DATA_ROOT", tree[0])
    return tree


def test_cli_trains_and_scores_mp6d(data_root, tmp_path, monkeypatch):
    from rdpn6d_tpu_torch.data import pipeline

    _, pool = data_root
    calls = {"surface": 0, "gt": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(pipeline, "surface_labels",
                        spy("surface", pipeline.surface_labels))
    monkeypatch.setattr(pipeline, "gt_labels", spy("gt", pipeline.gt_labels))
    results = record_evals(monkeypatch)
    out = str(tmp_path / "mp6d")
    state = train(config_path("mp6d"), out, pool)
    assert state.step == 2
    assert calls == {"surface": 2, "gt": 0}
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert (cfg["head"]["num_classes"], cfg["test"]["error_types"],
            cfg["data"]["change_bg_prob"]) == (
        20, "AUCadd,AUCadi,AUCad,vsd", 0.5)
    (res,) = results
    assert set(res["per_obj"]) <= {"obj_01", "obj_02", "obj_03", "obj_04"}
    for rec in [*res["per_obj"].values(), res["mean"]]:
        for k in ("AUCadd", "AUCadi", "AUCad"):
            assert np.isfinite(rec[k]), k
    assert os.path.exists(os.path.join(out, "mp6d_test_bop19.csv"))


def test_run_eval_mp6d_matches_jax(data_root, tmp_path):
    opts = OPTS + [f'train.output_dir="{tmp_path}"']
    jcfg = jax_config("mp6d", opts)
    tcfg = load_config(config_path("mp6d"), opts)
    state, ckpt = carried_weights(jcfg, tcfg, str(tmp_path))
    j, t = both_evals(jcfg, tcfg, "mp6d_test", ckpt, state, str(tmp_path))
    assert {"AUCadd", "AUCadi", "AUCad"} <= set(t["mean"])
    assert t["stats"]["n_rois"] == j["stats"]["n_rois"] > 0


def test_cli_trains_an_so_variant(data_root, tmp_path, monkeypatch):
    _, pool = data_root
    results = record_evals(monkeypatch)
    out = str(tmp_path / "so")
    state = train(config_path("so") + ":mp6d/obj_02", out, pool,
                  "solver.ims_per_batch=2", "train.eval_period=1")
    assert state.step >= 1
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert (cfg["head"]["num_classes"], cfg["data"]["train_datasets"],
            cfg["data"]["test_datasets"]) == (
        1, ["mp6d_obj_02_train"], ["mp6d_obj_02_test"])
    assert all(set(r["per_obj"]) == {"obj_02"} for r in results)
