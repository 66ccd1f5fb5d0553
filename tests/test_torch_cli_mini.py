"""The mini rehearsal config with the BOP19 AR's VSD, end to end on the
CPU: ``main --device cpu`` at tiny widths on a ``write_mini_tree`` tree
(LM scenes 91 and 92: a tetrahedron, a symmetric cube and an L-prism with
faces, rendered with the port's rasterizer) trains a few iterations and
evaluates on ``lm_mini_test``; then the port's ``run_eval`` against the
JAX package's on the same tree and weights.

What it holds: the AR has AR_vsd in [0, 1] beside AR_mssd and AR_mspd,
and AR is the mean of the three; VSD rendered every pose once (the render
cache's misses are the renders, and no pose was rendered twice), each GT
pose with an estimate among them. Against the JAX package (which renders
with its own rasterizer build): the CSV's identity columns equal, R and t
within 1e-4, the tables equal, and the BOP19 AR with VSD equal.
"""

import collections
import json
import os
import shutil

import numpy as np
import pytest
import torch

import rdpn6d_tpu.data.refs as jrefs
import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu_torch.config import load_config
from rdpn6d_tpu_torch.data.synthetic import write_mini_tree
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
    root = str(tmp_path_factory.mktemp("mini_cli"))
    write_mini_tree(root, n_train=4, n_test=3, seed=2)
    return root


@pytest.fixture
def data_root(tree, monkeypatch):
    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    monkeypatch.setattr(jrefs, "DATA_ROOT", tree)
    return tree


def test_cli_trains_and_scores_mini_with_vsd(data_root, tmp_path,
                                             monkeypatch):
    from rdpn6d_tpu_torch.evaluation import bop_score
    from rdpn6d_tpu_torch.ops import rasterizer

    renders, fns = [], []
    render = rasterizer.render_mesh

    def render_spy(v, f, K, R, t, H, W):
        renders.append((np.asarray(R, np.float64).tobytes(),
                        np.asarray(t, np.float64).tobytes()))
        return render(v, f, K, R, t, H, W)

    make = bop_score.make_vsd_error_fn

    def make_spy(*a, **kw):
        fns.append(make(*a, **kw))
        return fns[-1]

    monkeypatch.setattr(rasterizer, "render_mesh", render_spy)
    monkeypatch.setattr(bop_score, "make_vsd_error_fn", make_spy)
    results = record_evals(monkeypatch)
    out = str(tmp_path / "mini")
    state = train(config_path("mini"), out, "", "solver.ims_per_batch=4")
    assert state.step >= 1
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert "vsd" in cfg["test"]["error_types"].split(",")
    (res,) = results
    ar = res["bop19"]
    assert set(ar) == {"AR_mssd", "AR_mspd", "AR_vsd", "AR"}
    assert 0.0 <= ar["AR_vsd"] <= 1.0
    assert ar["AR"] == (ar["AR_vsd"] + ar["AR_mssd"] + ar["AR_mspd"]) / 3.0
    (fn,) = fns
    info = fn.render_cache_info()
    assert info.misses == len(renders) > 0
    assert max(collections.Counter(renders).values()) == 1
    # every target's GT pose among the renders (each target has an
    # estimate: the boxes are GT boxes)
    from rdpn6d_tpu_torch.data.bop import build_split_records, get_split

    targets = {(t["scene_id"], t["im_id"], t["obj_id"]) for t in json.load(
        open(os.path.join(data_root, "lm", "test_targets_mini.json")))}
    gt_poses = {(np.asarray(r["R"], np.float64).tobytes(),
                 np.asarray(r["t"], np.float64).tobytes())
                for r in build_split_records(get_split("lm_mini_test"))
                if (r["scene_id"], r["im_id"], r["obj_id"]) in targets}
    assert len(gt_poses) == len(targets) and gt_poses <= set(renders)


def test_run_eval_mini_with_vsd_matches_jax(data_root, tmp_path):
    opts = OPTS + [f'train.output_dir="{tmp_path}"']
    jcfg = jax_config("mini", opts)
    tcfg = load_config(config_path("mini"), opts)
    state, ckpt = carried_weights(jcfg, tcfg, str(tmp_path), seed=6)
    j, t = both_evals(jcfg, tcfg, "lm_mini_test", ckpt, state,
                      str(tmp_path))
    assert set(t["bop19"]) == {"AR_mssd", "AR_mspd", "AR_vsd", "AR"}
    assert t["bop19"] == j["bop19"]
