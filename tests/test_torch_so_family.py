"""``tools.train_so_family`` against the JAX package's
``tools/train_so_family.py``, loaded from its file:

  * for every SO family (and an ``--objs`` subset), the same objects in
    the same order, and for each the same ``main`` argv: the config's
    ``<dataset>/<obj>`` variant of ``configs/so.py`` (the port's copy),
    ``--eval-only``, ``--resume`` and ``--opts`` as given, plus the port's
    ``--device``;
  * the failure report: an object whose run raises is reported after the
    sweep, which goes on, and the exit code is 1, as the JAX tool prints;
  * two objects of the lm family trained and evaluated through the port's
    ``main`` at tiny widths on the CPU, on an lm + lm_imgn tree.
"""

import importlib.util
import json
import os
import sys

import pytest
import torch

import rdpn6d_tpu.main as jmain
import rdpn6d_tpu_torch.data.refs as trefs
import rdpn6d_tpu_torch.main as tmain
from rdpn6d_tpu_torch.data.synthetic import write_lm_imgn_tree, write_lm_tree
from rdpn6d_tpu_torch.tools import train_so_family

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["lm", "lmo", "ycbv", "mp6d", "tless", "tudl", "itodd", "icbin",
            "hb"]
OBJS = {"ape": 1, "can": 5}
TINY = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16", 'head.init="fan_in"', "loss.num_pm_points=500",
        "solver.ims_per_batch=4", "train.log_period=1",
        'backbone.pretrained=""', "solver.total_epochs=1",
        "train.eval_period=1"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_train_so_family",
        os.path.join(ROOT, "tools", "train_so_family.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorded(calls, fail=()):
    def run_main(argv):
        calls.append(list(argv))
        if any(argv[1].endswith(f"/{o}") for o in fail):
            raise RuntimeError("no data")
    return run_main


def sweep(flags, monkeypatch, capsys, fail=()):
    """(JAX argvs, port argvs, [JAX exit, port exit], both printed)."""
    j_calls, t_calls = [], []
    monkeypatch.setattr(jmain, "main", recorded(j_calls, fail))
    monkeypatch.setattr(tmain, "main", recorded(t_calls, fail))
    monkeypatch.setattr(sys, "argv", ["train_so_family", *flags])
    codes = []
    for run in (jax_tool().main,
                lambda: train_so_family.main([*flags, "--device", "cpu"])):
        try:
            run()
            codes.append(0)
        except SystemExit as e:
            codes.append(e.code)
    text = capsys.readouterr().out
    return j_calls, t_calls, codes, text


@pytest.mark.parametrize("flags", [
    *[["--dataset", ds] for ds in FAMILIES],
    ["--dataset", "tudl", "--objs", "dragon", "can", "--eval-only",
     "--resume", "--opts", "solver.ims_per_batch=48"]])
def test_object_argv_matches_jax(flags, monkeypatch, capsys):
    j_calls, t_calls, codes, _ = sweep(flags, monkeypatch, capsys)
    assert codes == [0, 0]
    assert len(t_calls) == len(j_calls) > 0
    if flags[1] == "lm":
        assert not {"bowl", "cup"} & {c[1].rsplit("/", 1)[1]
                                      for c in t_calls}
    so = os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "so.py")
    for t, j in zip(t_calls, j_calls):
        jpath, jvariant = j[1].rsplit(":", 1)
        assert os.path.normpath(jpath) == os.path.join(ROOT, "configs",
                                                       "so.py")
        assert t[1] == f"{so}:{jvariant}"
        at = t.index("--device")
        assert t[at + 1] == "cpu"
        assert t[:1] + t[2:at] + t[at + 2:] == j[:1] + j[2:]


def test_failure_report_matches_jax(monkeypatch, capsys):
    flags = ["--dataset", "tudl", "--objs", "dragon", "frog", "can"]
    j_calls, t_calls, codes, text = sweep(flags, monkeypatch, capsys,
                                          fail=("frog",))
    assert codes == [1, 1]
    assert len(j_calls) == len(t_calls) == 3
    half = text.index("=== [1/3]", 1)
    assert text[:half] == text[half:]
    assert "FAILED objects:\n  frog: RuntimeError('no data')" in text


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("so_tree"))
    write_lm_tree(root, OBJS, frames_per_obj=3, seed=6)
    write_lm_imgn_tree(root, OBJS, frames_per_obj=2, seed=7)
    return root


def test_two_lm_objects_train_and_score(tree, tmp_path, monkeypatch,
                                        capsys):
    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    out = str(tmp_path / "run")
    results = []
    run = tmain.main

    def spy(argv):
        results.append(run(argv))
        return results[-1]

    monkeypatch.setattr(tmain, "main", spy)
    train_so_family.main(["--dataset", "lm", "--objs", "ape", "can",
                          "--device", "cpu", "--opts", *TINY,
                          f'train.output_dir="{out}"'])
    text = capsys.readouterr().out
    assert "all 2 objects completed" in text
    assert [s.step for s in results] == [1, 1]   # 5 records, 4 a step
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["exp_name"] == "lmSO_can" and cfg["head"]["num_classes"] == 1
    for obj in OBJS:
        assert os.path.exists(os.path.join(out, f"lm_{obj}_test_bop19.csv"))
