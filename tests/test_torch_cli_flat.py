"""The flat train path, the debug eval and the checkpoint-serving
``Predictor`` through the port's entry points on the CPU, on an lm +
lm_imgn tree at the tiny config:

- ``main --device cpu`` with ``data.grouped_train=false`` trains lm13 one
  epoch from the flat loader (each batch one ``preprocess_batch``, no
  device frame cache) and checkpoints;
- ``main --eval-only --debug`` runs ``coord_regression_eval`` on that
  checkpoint (held to the JAX package's in ``test_torch_eval_runner.py``);
- ``Predictor(ckpt_dir=...)`` serves from the directory ``main`` wrote:
  its weights are the trained model's, tensor for tensor, and its poses
  the trained model's on the same preprocessed batch; a directory without
  a checkpoint is refused, as the JAX ``Predictor`` refuses it.

Tolerance: none, everything compared is equal.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu_torch import main as tmain
from rdpn6d_tpu_torch.config import load_config
from rdpn6d_tpu_torch.data import bop as tbop
from rdpn6d_tpu_torch.data.assets import load_class_assets
from rdpn6d_tpu_torch.data.loader import RecordDecoder
from rdpn6d_tpu_torch.data.pipeline import preprocess_rois_grouped
from rdpn6d_tpu_torch.data.synthetic import write_lm_imgn_tree, write_lm_tree
from rdpn6d_tpu_torch.engine import trainer
from rdpn6d_tpu_torch.engine.predictor import Detection, Predictor

OBJS = {"ape": 1, "can": 5}
CONFIG = "rdpn6d_tpu_torch/configs/lm13.py"
OPTS = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16", 'head.init="fan_in"', "loss.num_pm_points=500",
        "solver.ims_per_batch=4", "train.log_period=1",
        'backbone.pretrained=""', "data.grouped_train=false",
        'data.train_datasets=["cliflat_lm_train", "cliflat_imgn_train"]',
        'data.test_datasets=["cliflat_lm_test"]']


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The tree (2 objects x 3 frames in each layout), and one flat
    training run on it: (tree, output dir, final state, the frame shapes
    each step preprocessed)."""
    root = str(tmp_path_factory.mktemp("cli_flat"))
    write_lm_tree(root, OBJS, frames_per_obj=3, seed=4)
    write_lm_imgn_tree(root, OBJS, frames_per_obj=3, seed=5)
    tbop.register_split(tbop.Split(
        "cliflat_lm_train", "lm", "test", objs=tuple(OBJS),
        per_obj_index="image_set/{obj}_train.txt"))
    tbop.register_split(tbop.Split(
        "cliflat_imgn_train", "lm_imgn", "imgn", objs=tuple(OBJS),
        per_obj_index="image_set/train_{obj}.txt"))
    tbop.register_split(tbop.Split(
        "cliflat_lm_test", "lm", "test", objs=tuple(OBJS),
        filter_invalid=False, per_obj_index="image_set/{obj}_test.txt"))
    old_root = trefs.DATA_ROOT
    trefs.DATA_ROOT = root
    calls = []
    flat = trainer.preprocess_batch

    def spy(cfg, samples, *a, **kw):
        calls.append(tuple(samples["rgb"].shape))
        return flat(cfg, samples, *a, **kw)

    trainer.preprocess_batch = spy
    out = os.path.join(root, "run")
    try:
        state = tmain.main(["--config-file", CONFIG, "--device", "cpu",
                            "--opts", *OPTS, "solver.total_epochs=1",
                            f'train.output_dir="{out}"'])
    finally:
        trainer.preprocess_batch = flat
        trefs.DATA_ROOT = old_root
    yield root, out, state, calls
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture
def data_root(run, monkeypatch):
    monkeypatch.setattr(trefs, "DATA_ROOT", run[0])
    return run


def test_main_trains_the_flat_path(data_root):
    """6 + 6 records at 4 ROIs a step: 3 iterations, each preprocessing 4
    full frames of its own; one checkpoint, and no device frame cache
    metrics in the log."""
    _, out, state, calls = data_root
    assert state.step == 3 and calls == [(4, 480, 640, 3)] * 3
    assert os.listdir(os.path.join(out, "ckpt")) == ["3"]
    log = open(os.path.join(out, "log.txt")).read()
    assert "3 iters/epoch" in log and "dev_cache" not in log


def test_main_debug_eval(data_root):
    """``--eval-only --debug``: the masked coordinate L1 of the 6 test
    instances, finite, logged, and the same on a second run."""
    _, out, _, _ = data_root
    argv = ["--config-file", CONFIG, "--eval-only", "--debug", "--device",
            "cpu", "--opts", *OPTS, f'train.output_dir="{out}"']
    res = tmain.main(argv)["cliflat_lm_test"]
    assert res["n"] == 6 and np.isfinite(res["coord_l1"])
    assert 0 < res["coord_l1"] < 10
    assert tmain.main(argv)["cliflat_lm_test"] == res
    assert "coord regression debug [cliflat_lm_test]" in open(
        os.path.join(out, "log.txt")).read()


def test_predictor_serves_the_checkpoint_main_wrote(data_root, tmp_path):
    root, out, state, _ = data_root
    cfg = load_config(CONFIG, OPTS)
    ref = trefs.get_ref("lm")
    assets = load_class_assets(ref, 4, 500, objs=list(OBJS))
    pred = Predictor(cfg, assets, ckpt_dir=os.path.join(out, "ckpt"),
                     dtype=torch.float32, device="cpu")
    trained = state.model.state_dict()
    served = pred.model.state_dict()
    assert served.keys() == trained.keys()
    assert all(torch.equal(served[k], trained[k].float()) for k in served)

    rec = tbop.build_split_records(tbop.get_split("cliflat_lm_test"))[0]
    frame = RecordDecoder(cfg).read_frame(rec)
    depth = frame["depth_raw"].astype(np.float32) / frame["depth_factor"]
    x, y, w, h = rec["bbox_visib"]
    box = np.array([x, y, x + w, y + h], np.float32)
    (got,) = pred.predict(frame["rgb"].copy(), depth, rec["K"],
                          [Detection(rec["obj_id"], box)])
    a = assets.for_obj(rec["obj_id"])
    batch = preprocess_rois_grouped(cfg, {
        "rgb": torch.from_numpy(frame["rgb"][None].copy()),
        "depth": torch.from_numpy(depth[None]),
        "K": torch.from_numpy(rec["K"][None])}, {
        "frame_idx": torch.zeros(1, dtype=torch.long),
        "bbox": torch.from_numpy(box[None]),
        "fps": torch.from_numpy(a["fps"][None].astype(np.float32)),
        "extent": torch.from_numpy(a["extent"][None].astype(np.float32)),
        "roi_cls": torch.tensor([assets.full_idx(rec["obj_id"])])})
    model = state.model.eval()
    with torch.no_grad():
        ref_out = model(batch)
    np.testing.assert_array_equal(got["R"], ref_out["rot_ego"][0].numpy())
    np.testing.assert_array_equal(got["t"], ref_out["trans"][0].numpy())
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        Predictor(cfg, assets, ckpt_dir=str(tmp_path / "empty"),
                  device="cpu")
