"""The BOP experiment configs that train on PBR frames alone, end to end
on the CPU: ``main --device cpu`` at tiny widths on ``write_bop_tree``
trees of hb and icbin trains a few iterations, every one with labels from
the depth surface (PBR frames ship no GT xyz crops), and evaluates: hb on
its ``val_primesense`` scene (no BOP19 targets, so no AR), icbin on its
BOP19 targets with the MSSD/MSPD AR.
"""

import json
import os
import shutil

import pytest
import torch

import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu_torch.data.synthetic import write_bg_pool, write_bop_tree
from tests.test_torch_cli_bop import config_path, read_csv, record_evals, train


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
    root = str(tmp_path_factory.mktemp("bop_pbr_cli"))
    for i, ds in enumerate(("hb", "icbin")):
        write_bop_tree(root, ds, pbr_frames=2, test_frames=2, seed=5 + i)
    return root, write_bg_pool(os.path.join(root, "VOC"), seed=4)


@pytest.mark.parametrize("ds, classes, with_ar", [("hb", 33, False),
                                                  ("icbin", 2, True)])
def test_cli_trains_and_scores_pbr_only(tree, tmp_path, monkeypatch, ds,
                                        classes, with_ar):
    from rdpn6d_tpu_torch.data import pipeline

    root, pool = tree
    monkeypatch.setattr(trefs, "DATA_ROOT", root)
    calls = {"depth": 0, "gt": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(pipeline, "surface_labels",
                        spy("depth", pipeline.surface_labels))
    monkeypatch.setattr(pipeline, "gt_labels", spy("gt", pipeline.gt_labels))
    results = record_evals(monkeypatch)
    out = str(tmp_path / ds)
    state = train(config_path(ds), out, pool)
    assert state.step == 2
    assert calls == {"depth": 2, "gt": 0}
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert cfg["head"]["num_classes"] == classes
    (res,) = results
    split = cfg["data"]["test_datasets"][0]
    ident, _, _ = read_csv(os.path.join(out, f"{split}_bop19.csv"))
    assert len(ident) > 0 and res["per_obj"]
    if with_ar:
        targets = json.load(open(os.path.join(root, ds,
                                              "test_targets_bop19.json")))
        assert len(ident) == sum(t["inst_count"] for t in targets)
        assert set(res["bop19"]) == {"AR_mssd", "AR_mspd", "AR"}
        assert all(0.0 <= v <= 1.0 for v in res["bop19"].values())
    else:
        assert split == "hb_bop_test" and "bop19" not in res
