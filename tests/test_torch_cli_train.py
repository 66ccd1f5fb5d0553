"""The port's train entry point end to end on the CPU: ``python -m
rdpn6d_tpu_torch.main`` without ``--eval-only``, on a tree that holds an
lm train split and an lm_imgn split (``data/synthetic``), at the tiny
config with ``--device cpu``.

What it holds: the run writes ``config.json``, one ``metrics.json`` line a
log period and a checkpoint a checkpoint period; it evaluates the live
model during training; ``--resume`` continues from the saved step with the
model, the optimizer state and the step restored (a resumed run with
nothing left to do hands back the checkpoint exactly, tensor for tensor);
the pretrained trunk is the .pth's before the first step and is skipped
on resume; a missing .pth raises; evaluating the live model leaves its
float32 weights bit-unchanged and its train mode on, and runs under bf16
autocast only with ``solver.amp``; ``python -m`` runs the module as a
program; and the refusals. And the lmo config (``configs/lmo.py``) on a
``write_lmo_tree`` tree with a ``write_bg_pool`` pool: colour aug,
background replacement with truncated foregrounds and TRAIN2 on the
BOP-PBR split (JPEG frames, no xyz crops, so its labels come from the
depth surface) run, then eval on ``lmo_bop_test``. Tolerance: none,
everything compared is equal.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import pytest
import torch

import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu_torch import main as tmain
from rdpn6d_tpu_torch.config import Config
from rdpn6d_tpu_torch.data import bop as tbop
from rdpn6d_tpu_torch.data.synthetic import (
    write_bg_pool,
    write_lm_imgn_tree,
    write_lm_tree,
    write_lmo_tree,
    write_resnet_pth,
)
from rdpn6d_tpu_torch.engine.checkpoint import STATE_FILE, CheckpointManager
from rdpn6d_tpu_torch.engine.eval_runner import run_eval
from rdpn6d_tpu_torch.models import RDPN, init_weights
from rdpn6d_tpu_torch.parallel import create_train_state

OBJS = {"ape": 1, "can": 5}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "rdpn6d_tpu_torch/configs/lm13.py"
OPTS = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16", 'head.init="fan_in"', "loss.num_pm_points=500",
        "solver.ims_per_batch=4",
        'data.train_datasets=["cli_lm_train", "cli_imgn_train"]',
        'data.test_datasets=["cli_lm_test"]', "train.log_period=1",
        'backbone.pretrained=""']


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """A checkpoint of the tiny config is ~190 MB (ResNet-18's weights and
    Ranger's state): each test's directory goes when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """2 objects x 3 frames in each layout: 6 + 4 train records (imgn cut
    to 2 an object), so 2 iterations an epoch at 4 ROIs a step."""
    root = str(tmp_path_factory.mktemp("cli_tree"))
    write_lm_tree(root, OBJS, frames_per_obj=3, seed=6)
    write_lm_imgn_tree(root, OBJS, frames_per_obj=3, seed=7)
    tbop.register_split(tbop.Split(
        "cli_lm_train", "lm", "test", objs=tuple(OBJS),
        per_obj_index="image_set/{obj}_train.txt"))
    tbop.register_split(tbop.Split(
        "cli_imgn_train", "lm_imgn", "imgn", objs=tuple(OBJS), n_per_obj=2,
        per_obj_index="image_set/train_{obj}.txt"))
    tbop.register_split(tbop.Split(
        "cli_lm_test", "lm", "test", objs=tuple(OBJS), filter_invalid=False,
        per_obj_index="image_set/{obj}_test.txt"))
    return root


@pytest.fixture
def data_root(tree, monkeypatch):
    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    return tree


def train(out, *extra, resume=False, profile=False):
    argv = ["--config-file", CONFIG, "--device", "cpu"] \
        + (["--resume"] if resume else []) \
        + (["--profile"] if profile else []) \
        + ["--opts", *OPTS, f'train.output_dir="{out}"', *extra]
    return tmain.main(argv)


def metrics(out):
    with open(os.path.join(out, "metrics.json")) as f:
        return [json.loads(ln) for ln in f]


def test_cli_trains_from_disk(data_root, tmp_path):
    """2 epochs = 4 iterations: a checkpoint each epoch, a metrics line
    each iteration (log_period 1) with the device cache's stats, the
    config dump, and eval at iteration 4 writing the split's CSV."""
    out = str(tmp_path / "run")
    state = train(out, "solver.total_epochs=2",
                  "train.checkpoint_period_epochs=1", "train.eval_period=4")
    assert state.step == 4
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["2", "4"]
    assert all(os.path.isfile(os.path.join(out, "ckpt", s, STATE_FILE))
               for s in ("2", "4"))
    lines = metrics(out)
    assert [ln["iteration"] for ln in lines] == [1, 2, 3, 4]
    assert all(torch.isfinite(torch.tensor(ln["total_loss"]))
               for ln in lines)
    assert {"lr", "grad_norm", "frame_cache_hit_rate",
            "frame_cache_resident_mb", "frame_cache_frames"} <= set(lines[0])
    # 10 frames cycle through the cache: the second epoch hits
    assert lines[-1]["frame_cache_hit_rate"] > 0
    cfg = json.loads(open(os.path.join(out, "config.json")).read())
    assert cfg["data"]["train_datasets"] == ["cli_lm_train",
                                             "cli_imgn_train"]
    csv = open(os.path.join(out, "cli_lm_test_bop19.csv")).read()
    assert len(csv.strip().splitlines()) == 1 + 6
    assert "4 total iters" in open(os.path.join(out, "log.txt")).read()


def test_cli_resume_restores_model_optimizer_and_step(data_root, tmp_path):
    out = str(tmp_path / "run")
    first = train(out, "solver.total_epochs=1", profile=True)
    assert first.step == 2
    assert os.path.getsize(os.path.join(out, "profile", "trace.json")) > 0
    saved = torch.load(os.path.join(out, "ckpt", "2", STATE_FILE),
                       weights_only=True)
    # nothing left to do: the resumed state is the checkpoint, exactly
    same = train(out, "solver.total_epochs=1", resume=True)
    assert same.step == 2
    for k, v in saved["model"].items():
        assert torch.equal(same.model.state_dict()[k], v), k
    opt = same.optimizer.state_dict()
    assert opt["state"].keys() == saved["optimizer"]["state"].keys()
    for i, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(opt["state"][i][k]),
                               torch.as_tensor(v)), (i, k)
    # a later horizon: training goes on from iteration 3
    more = train(out, "solver.total_epochs=2", resume=True)
    assert more.step == 4
    assert [ln["iteration"] for ln in metrics(out)] == [1, 2, 3, 4]
    assert "resumed from iteration 2" in \
        open(os.path.join(out, "log.txt")).read()


def test_cli_pretrained_trunk(data_root, tmp_path, monkeypatch):
    """The trunk is the .pth's before the first step (a 0-epoch run hands
    back the initial state); resume skips the load; a missing file
    raises."""
    for var in ("RDPN6D_PRETRAINED_DIR", "TORCH_HOME", "RDPN6D_DATA_ROOT"):
        monkeypatch.setenv(var, str(tmp_path / "nowhere"))
    pre = ['backbone.pretrained="torchvision://resnet18"']
    with pytest.raises(FileNotFoundError, match="from scratch"):
        train(str(tmp_path / "a"), *pre, "solver.total_epochs=1")
    pth = write_resnet_pth(str(tmp_path / "pre" / "resnet18-seeded.pth"),
                           depth=18, seed=3)
    monkeypatch.setenv("RDPN6D_PRETRAINED_DIR", str(tmp_path / "pre"))
    state = train(str(tmp_path / "b"), *pre, "solver.total_epochs=0")
    assert state.step == 0
    sd = torch.load(pth, weights_only=True)
    got = state.model.state_dict()
    for k, v in sd.items():
        if not k.startswith("fc."):
            assert torch.equal(got[f"backbone.{k}"], v), k
    out = str(tmp_path / "c")
    # from scratch, and with frames streamed (no device frame cache)
    train(out, "solver.total_epochs=1", "data.device_frame_cache_mb=0")
    os.remove(pth)                                # resume must not need it
    resumed = train(out, *pre, "solver.total_epochs=1", resume=True)
    trunk = resumed.model.state_dict()["backbone.conv1.weight"]
    assert not torch.equal(trunk, sd["conv1.weight"])


def test_eval_of_the_live_model_leaves_it_untouched(data_root, tmp_path):
    """run_eval(model=...) in bf16 autocast on the trainer's float32
    model: weights, BatchNorm statistics and dtypes bit-unchanged, train
    mode handed back; and the same poses as evaluating a checkpoint of it
    in float32."""
    cfg = Config().apply_opts(OPTS + [f'train.output_dir="{tmp_path}"'])
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(2)).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    res = run_eval(cfg, ckpt_dir="", split_name="cli_lm_test", model=model,
                   csv_path=str(tmp_path / "live.csv"))
    assert res["stats"]["n_rois"] == 6
    assert model.training
    for k, v in model.state_dict().items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k
    run_eval(cfg, ckpt_dir="", split_name="cli_lm_test", model=model,
             dtype=torch.float32, csv_path=str(tmp_path / "f32.csv"))
    assert model.training
    CheckpointManager(str(tmp_path / "ckpt")).save(
        0, create_train_state(cfg, model))
    run_eval(cfg, ckpt_dir=str(tmp_path / "ckpt"), split_name="cli_lm_test",
             dtype=torch.float32, device="cpu",
             csv_path=str(tmp_path / "ckpt.csv"))

    def poses(name):      # R and t columns; the time column differs
        rows = open(tmp_path / name).read().strip().splitlines()[1:]
        return [r.split(",")[:6] for r in rows]

    assert poses("f32.csv") == poses("ckpt.csv")


@pytest.mark.parametrize("amp", [True, False])
def test_cli_eval_during_training_runs_in_the_models_precision(
        data_root, tmp_path, monkeypatch, amp):
    """Eval during training runs the live model as the JAX package does
    (``rdpn6d_tpu/main.py`` builds it in bf16 only with ``solver.amp``):
    inside the model's forward, bf16 autocast is on with ``solver.amp`` and
    off without."""
    from rdpn6d_tpu_torch.engine import eval_runner

    seen = []
    orig = eval_runner.run_eval

    def recording(*args, model=None, **kw):
        hook = model.register_forward_pre_hook(lambda m, a: seen.append(
            (torch.is_autocast_enabled("cpu"),
             torch.get_autocast_dtype("cpu"))))
        try:
            return orig(*args, model=model, **kw)
        finally:
            hook.remove()

    monkeypatch.setattr(eval_runner, "run_eval", recording)
    state = train(str(tmp_path / "run"), f"solver.amp={str(amp).lower()}",
                  "solver.total_epochs=1", "train.eval_period=2")
    assert state.step == 2 and seen
    assert all(on == amp for on, _ in seen), seen
    if amp:
        assert all(dt == torch.bfloat16 for _, dt in seen), seen


def test_cli_runs_as_a_module(tree, tmp_path):
    """``python -m rdpn6d_tpu_torch.main`` trains, checkpoints, writes
    ``config.json`` and ``metrics.json`` and evaluates, on the tree's
    per-object splits named by ``RDPN6D_DATA_ROOT``; the flat train path
    (``data.grouped_train=false``), once refused with a non-zero exit,
    trains and checkpoints as a module too."""
    env = dict(os.environ, RDPN6D_DATA_ROOT=tree, OMP_NUM_THREADS="2",
               PYTHONPATH=ROOT)
    out = str(tmp_path / "run")
    argv = [sys.executable, "-m", "rdpn6d_tpu_torch.main", "--config-file",
            CONFIG, "--device", "cpu", "--opts", *OPTS,
            'data.train_datasets=["lm_ape_train", '
            '"lm_imgn_ape_train_1k_per_obj"]',
            'data.test_datasets=["lm_ape_test"]', "solver.total_epochs=1",
            "train.checkpoint_period_epochs=1", "train.eval_period=1",
            f'train.output_dir="{out}"']
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # 3 + 3 records of ape at 4 ROIs a step: 1 iteration
    assert os.listdir(os.path.join(out, "ckpt")) == ["1"]
    assert [ln["iteration"] for ln in metrics(out)] == [1]
    assert os.path.isfile(os.path.join(out, "config.json"))
    csv = open(os.path.join(out, "lm_ape_test_bop19.csv")).read()
    assert len(csv.strip().splitlines()) == 1 + 3
    flat_out = str(tmp_path / "flat")
    flat = subprocess.run(argv + ["data.grouped_train=false",
                                  "train.eval_period=0",
                                  f'train.output_dir="{flat_out}"'],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert flat.returncode == 0, flat.stderr[-3000:]
    assert os.listdir(os.path.join(flat_out, "ckpt")) == ["1"]
    assert [ln["iteration"] for ln in metrics(flat_out)] == [1]


def test_train2_mixing_draws_from_the_seeded_stream(tmp_path):
    """TRAIN2: each iteration takes its batch from the second loader when
    RandomState(train.seed).rand() < train2_ratio, as the JAX trainer
    draws."""
    import numpy as np

    from rdpn6d_tpu_torch.data.synthetic import dummy_train_batch
    from rdpn6d_tpu_torch.engine.trainer import Trainer

    cfg = Config().apply_opts(OPTS + ["solver.amp=false", "train.seed=5",
                                      "train.checkpoint_period_epochs=1e9",
                                      f'train.output_dir="{tmp_path}"'])
    pulled = []

    def loader(tag):
        while True:
            pulled.append(tag)
            yield dummy_train_batch(cfg, 2, seed=len(pulled))

    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(0))
    Trainer(cfg, model, total_iters=6, device="cpu").train(
        loader(1), loader2=loader(2), train2_ratio=0.4)
    rng = np.random.RandomState(5)
    assert pulled == [2 if rng.rand() < 0.4 else 1 for _ in range(6)]
    assert set(pulled) == {1, 2}


def test_tensorboard_panels(tmp_path, caplog):
    """Every 10 log periods the trainer writes weight histograms
    (``train.tb_histograms``) and image panels to ``<output_dir>/tb``
    where TensorBoard imports, and never fails the run over them."""
    import logging

    from rdpn6d_tpu_torch.data.synthetic import dummy_grouped_inputs
    from rdpn6d_tpu_torch.engine.trainer import Trainer

    cfg = Config().apply_opts(OPTS + ["solver.amp=false",
                                      "train.tb_histograms=true",
                                      "train.checkpoint_period_epochs=1e9",
                                      f'train.output_dir="{tmp_path}"'])
    frames, rois = dummy_grouped_inputs(cfg, n_frames=1, rois_per_frame=2,
                                        ship_xyz=True)
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(0))
    trainer = Trainer(cfg, model, total_iters=10, device="cpu")
    with caplog.at_level(logging.ERROR, logger="rdpn6d"):
        trainer.train(iter([{"frames": frames, "rois": rois}] * 10))
    assert "panels" not in caplog.text
    if trainer.tb.enabled:
        trainer.tb.close()
        events = os.listdir(tmp_path / "tb")
        assert any(e.startswith("events.out.tfevents") for e in events)


def test_cli_train_refusals(data_root, tmp_path):
    base = ["--config-file", CONFIG, "--opts", *OPTS,
            f'train.output_dir="{tmp_path}"']
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmain.main(base)
        assert not os.path.exists(tmp_path / "config.json")
    cpu = ["--device", "cpu"]
    # the flat train path, once refused, trains: 6 + 4 records at 4 ROIs
    state = tmain.main(base + ["data.grouped_train=false",
                               "solver.total_epochs=1"] + cpu)
    assert state.step == 2
    # colour aug and background replacement, once refused, now run
    # (test_cli_trains_lmo trains with them)
    state = tmain.main(base + ["data.change_bg_prob=0.5",
                               "data.color_aug_prob=0.8",
                               "solver.total_epochs=0"] + cpu)
    assert state.step == 0
    # --multihost, once refused, joins a group; here a group of one on
    # the CPU (gloo), whose collectives run (test_torch_dist_cli.py runs
    # two processes)
    port = _free_port()
    state = tmain.main(base + ["solver.total_epochs=0"] + cpu + [
        "--multihost", "--dist-coordinator", f"127.0.0.1:{port}",
        "--num-processes", "1", "--process-id", "0"])
    assert state.step == 0
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="--multihost needs"):
        tmain.main(base + cpu + ["--multihost", "--num-processes", "2"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_num_devices_refusals(data_root, tmp_path, monkeypatch):
    """More processes than visible cards, one named card for several
    processes, and a multi-host batch that does not divide, all raise
    before any work."""
    base = ["--config-file", CONFIG, "--opts", *OPTS,
            f'train.output_dir="{tmp_path}"']
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 CUDA device"):
        tmain.main(base[:2] + ["--num-devices", "2"] + base[2:])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="one named card"):
        tmain.main(base[:2] + ["--device", "cuda:0"] + base[2:])
    with pytest.raises(ValueError, match="divisible by the 3"):
        tmain.main(base[:2] + ["--multihost", "--dist-coordinator",
                               "127.0.0.1:1", "--num-processes", "3",
                               "--process-id", "0"] + base[2:])
    assert not os.path.exists(tmp_path / "config.json")


LMO_CONFIG = "rdpn6d_tpu_torch/configs/lmo.py"


@pytest.fixture(scope="module")
def lmo_tree(tmp_path_factory):
    """lmo: 2 real frames and 2 PBR frames (one scene) of 4 occluding
    cubes each, 1 test frame; a background pool beside it."""
    root = str(tmp_path_factory.mktemp("lmo_cli"))
    write_lmo_tree(root, train_frames=2, pbr_scenes=1, pbr_frames=2,
                   test_frames=1, insts_per_frame=4, seed=3)
    return root, write_bg_pool(os.path.join(root, "VOC"), seed=4)


def test_cli_trains_lmo(lmo_tree, tmp_path, monkeypatch):
    """``main`` on configs/lmo.py at tiny widths, one epoch of 2
    iterations (8 real records at 4 ROIs a step) with TRAIN2 at 0.6, so
    that RandomState(0) sends the first iteration to ``lmo_pbr_train``:
    that batch's labels come from the depth surface through
    ``surface_labels``, the other's through ``gt_labels``; colour aug runs
    on every batch; instances given background replacement stream as
    private frames; every logged loss is finite; eval on ``lmo_bop_test``
    writes a CSV row a target."""
    from rdpn6d_tpu_torch.data import device_cache, pipeline

    root, pool = lmo_tree
    monkeypatch.setattr(trefs, "DATA_ROOT", root)
    calls = {"depth": 0, "gt": 0, "aug": 0, "private": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(pipeline, "surface_labels",
                        spy("depth", pipeline.surface_labels))
    monkeypatch.setattr(pipeline, "gt_labels", spy("gt", pipeline.gt_labels))
    monkeypatch.setattr(pipeline, "color_augment",
                        spy("aug", pipeline.color_augment))
    stack = device_cache.DeviceFrameCache.stack

    def counting_stack(self, slots):
        calls["private"] += sum(k is None for k, _ in slots)
        return stack(self, slots)

    monkeypatch.setattr(device_cache.DeviceFrameCache, "stack",
                        counting_stack)
    out = str(tmp_path / "lmo")
    state = tmain.main(
        ["--config-file", LMO_CONFIG, "--device", "cpu", "--opts",
         *OPTS[:-4], "train.log_period=1", 'backbone.pretrained=""',
         f'data.bg_images_dir="{pool}"', "data.train2_ratio=0.6",
         "solver.total_epochs=1", "train.eval_period=2",
         f'train.output_dir="{out}"'])
    assert state.step == 2
    assert calls["depth"] == 1 and calls["gt"] == 1 and calls["aug"] == 2
    assert calls["private"] > 0
    lines = metrics(out)
    assert [ln["iteration"] for ln in lines] == [1, 2]
    assert all(torch.isfinite(torch.tensor(v)) for ln in lines
               for k, v in ln.items() if k.startswith("loss")
               or k in ("total_loss", "grad_norm"))
    cfg = json.loads(open(os.path.join(out, "config.json")).read())
    assert cfg["data"]["train2_datasets"] == ["lmo_pbr_train"]
    assert (cfg["data"]["color_aug_type"], cfg["head"]["num_classes"]) == \
        ("code", 8)
    targets = json.load(open(os.path.join(root, "lmo",
                                          "test_targets_bop19.json")))
    csv = open(os.path.join(out, "lmo_bop_test_bop19.csv")).read()
    assert len(csv.strip().splitlines()) == 1 + len(targets) > 1
