"""The port's CLI on several processes of the CPU: ``--multihost`` joins
two separate ``python -m rdpn6d_tpu_torch.main`` processes through a
coordinator address on this host and trains one epoch; then ``main
--device cpu --num-devices 2 --resume`` spawns two gloo ranks that resume
from its checkpoint, train a second epoch and evaluate ``lm_ape_test``
(each rank its frame shard; rank 0 writes the pooled CSV). The tiny
configuration on a synthetic LM tree (``lm_ape_train``, 4 frames: one
iteration an epoch at a global batch of 4, 2 ROIs a rank); rank 0 alone
writes ``config.json``, ``metrics.json`` (one line an iteration) and each
checkpoint. The processes read the tree through ``RDPN6D_DATA_ROOT`` and
run one CPU thread each (``OMP_NUM_THREADS``). Tolerance: none,
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

from rdpn6d_tpu_torch import main as tmain
from rdpn6d_tpu_torch.data.synthetic import write_lm_tree
from rdpn6d_tpu_torch.engine.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "rdpn6d_tpu_torch/configs/lm13.py"
OPTS = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16", 'head.init="fan_in"', "loss.num_pm_points=500",
        "solver.ims_per_batch=4", "train.log_period=1",
        'data.train_datasets=["lm_ape_train"]',
        'data.test_datasets=["lm_ape_test"]', 'backbone.pretrained=""',
        "train.checkpoint_period_epochs=1"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_cli_tree"))
    write_lm_tree(root, {"ape": 1}, frames_per_obj=4, seed=6)
    return root


def _argv(out, *extra, flags=()):
    return ["--config-file", CONFIG, "--device", "cpu", *flags,
            "--opts", *OPTS, f'train.output_dir="{out}"', *extra]


def _metrics(out):
    with open(os.path.join(out, "metrics.json")) as f:
        return [json.loads(ln) for ln in f]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run_dir(tree, tmp_path_factory):
    """One epoch through ``--multihost``: two subprocesses, ranks 0 and
    1 of one group through a coordinator address on this host."""
    out = str(tmp_path_factory.mktemp("dist_cli") / "run")
    env = {**os.environ, "RDPN6D_DATA_ROOT": tree, "OMP_NUM_THREADS": "1"}
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rdpn6d_tpu_torch.main",
         *_argv(out, "solver.total_epochs=1", "train.eval_period=0",
                flags=["--multihost", "--dist-coordinator", coord,
                       "--num-processes", "2", "--process-id", str(r)])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    yield out, [p.returncode for p in procs], logs
    shutil.rmtree(out, ignore_errors=True)   # ~190 MB a checkpoint


def test_multihost_two_processes_train(run_dir):
    out, rcs, logs = run_dir
    assert rcs == [0, 0], logs
    assert [ln["iteration"] for ln in _metrics(out)] == [1]
    assert os.listdir(os.path.join(out, "ckpt")) == ["1"]
    log = open(os.path.join(out, "log.txt")).read()
    assert "rank 0 of 2" in log and "1 total iters" in log
    assert "rank 1 of 2" in open(os.path.join(out, "log.txt.rank1")).read()
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert cfg["solver"]["ims_per_batch"] == 4


def test_num_devices_2_resumes_trains_and_evaluates(run_dir, tree,
                                                    monkeypatch):
    """``--num-devices 2 --resume`` on the multihost run's checkpoint,
    with a 2-epoch horizon: one more iteration, a checkpoint, eval."""
    out, rcs, _ = run_dir
    assert rcs == [0, 0]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("RDPN6D_DATA_ROOT", tree)
    assert tmain.main(_argv(out, "solver.total_epochs=2",
                            "train.eval_period=2",
                            flags=["--num-devices", "2", "--resume"])) \
        is None
    lines = _metrics(out)
    assert [ln["iteration"] for ln in lines] == [1, 2]
    assert all(torch.isfinite(torch.tensor(ln["total_loss"]))
               for ln in lines)
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["1", "2"]
    assert CheckpointManager(os.path.join(out, "ckpt")).latest_step() == 2
    log = open(os.path.join(out, "log.txt")).read()
    assert "resumed from iteration 1" in log
    # eval: 4 frames, 2 a rank; rank 0 writes the pooled CSV
    csv = open(os.path.join(out, "lm_ape_test_bop19.csv")).read()
    assert len(csv.strip().splitlines()) == 1 + 4
