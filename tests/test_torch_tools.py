"""The port's tools (``python -m rdpn6d_tpu_torch.tools.<name>``) against
the JAX package's ``tools/<name>.py`` on a tiny synthetic LM split (two
cube objects, 3 frames each) and the same seeded weights:

  * ``eval_split``: ``tests/test_torch_tools_eval.py``;
  * ``score_csv``: the same printed table, and the same BOP19 AR line, on
    one CSV;
  * ``fuse_detections``: the same JSON, and the same printed line;
  * ``strip_checkpoint``: from an orbax step and a port step of the same
    weights, the same weights (the port's ``state_dict`` against
    ``state_dict_from_flax`` of the JAX pickle, bit for bit); the hash in
    the file name is the file's; the optimizer is gone; the stripped
    directory serves through ``Predictor(ckpt_dir=...)``;
  * ``compute_fps``: the same pickle, array for array, bit for bit;
  * ``convert_checkpoint``: a reference-layout ``.pth`` to the port's
    checkpoint holds exactly the weights the JAX tool's flax pickle maps
    to; a JAX ``params.pkl`` likewise.
"""

import importlib.util
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import rdpn6d_tpu.data.refs as jrefs
import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.engine.checkpoint import CheckpointManager as JCheckpoints
from rdpn6d_tpu.parallel import create_train_state as j_train_state
from rdpn6d_tpu.solver import build_optimizer as j_build_optimizer
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.tools import (
    compute_fps,
    convert_checkpoint,
    fuse_detections,
    score_csv,
    strip_checkpoint,
)
from rdpn6d_tpu_torch.utils.flax_params import state_dict_from_flax
from tests.test_torch_eval_runner import (  # noqa: F401  (fixtures)
    OBJS,
    OPTS,
    tree,
    weights,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def roots(tree, monkeypatch):
    monkeypatch.setattr(jrefs, "DATA_ROOT", tree)
    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    return tree


def _jax_tool(name, argv, monkeypatch):
    """Run ``tools/<name>.py``'s main with ``argv``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    return mod.main()


def _configs(tmp_path):
    """A config file of each package: the default config (the tiny
    model comes through --opts)."""
    paths = {}
    for tag, pkg in (("jax", "rdpn6d_tpu"), ("port", "rdpn6d_tpu_torch")):
        p = tmp_path / f"{tag}_cfg.py"
        p.write_text(f"from {pkg}.config import Config\n\n\n"
                     "def get_config():\n    return Config()\n")
        paths[tag] = str(p)
    return paths


@pytest.fixture
def orbax_ckpt(weights, tmp_path):
    """The weights fixture's variables as an orbax step of the JAX
    package (its eval's train-state layout)."""
    params, stats, _ = weights
    jcfg = JConfig().apply_opts(OPTS)
    state = j_train_state(jcfg, {"params": params, "batch_stats": stats},
                          j_build_optimizer(jcfg, total_iters=1))
    mgr = JCheckpoints(str(tmp_path / "orbax"))
    mgr.save(7, state)
    mgr.wait()
    return str(tmp_path / "orbax")


def _gt_csv(tree, path, rng):
    """A result CSV of each two_obj_test instance's GT pose, perturbed
    (some within the ADD thresholds, some not), one of them twice."""
    from rdpn6d_tpu_torch.data.bop import build_split_records, get_split
    from rdpn6d_tpu_torch.data.inout import save_bop_results_csv

    rows = []
    for i, rec in enumerate(build_split_records(get_split("two_obj_test"))):
        ang = rng.randn(3) * (0.01, 0.05, 0.2)[i % 3]
        from rdpn6d_tpu_torch.ops.pnp_host import rodrigues

        R = rodrigues(ang) @ rec["R"]
        t = rec["t"] + rng.randn(3) * (0.002, 0.01, 0.05)[i % 3]
        rows.append({"scene_id": rec["scene_id"], "im_id": rec["im_id"],
                     "obj_id": rec["obj_id"], "score": 0.5 + 0.05 * i,
                     "R": R, "t": t, "time": 0.1})
    rows.append(dict(rows[0], score=0.1, t=rows[0]["t"] + 0.3))
    save_bop_results_csv(path, rows)


def test_score_csv_matches_jax(roots, tmp_path, monkeypatch, capsys):
    path = str(tmp_path / "res.csv")
    _gt_csv(roots, path, np.random.RandomState(0))
    args = ["--csv", path, "--split", "two_obj_tgt", "--bop19"]
    capsys.readouterr()
    _jax_tool("score_csv", args, monkeypatch)
    j = capsys.readouterr().out
    score_csv.main(args + ["--device", "cpu"])
    t = capsys.readouterr().out
    assert "MEAN" in t and "BOP19:" in t
    assert t == j


def test_fuse_detections_matches_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.RandomState(1)
    inputs = []
    for k in range(2):
        dets = [{"scene_id": int(s), "im_id": int(i), "obj_id": int(o),
                 "bbox_est": [float(x) for x in rng.uniform(0, 200, 4)],
                 "score": float(rng.rand()), "time": 0.01 * k}
                for s, i, o in rng.randint(1, 4, (12, 3))]
        p = tmp_path / f"d{k}.json"
        p.write_text(json.dumps(dets))
        inputs.append(str(p))
    for keep in ("1", "2"):
        capsys.readouterr()
        _jax_tool("fuse_detections", [*inputs, "--out",
                                      str(tmp_path / "j.json"), "--keep",
                                      keep], monkeypatch)
        j_out = capsys.readouterr().out
        fuse_detections.main([*inputs, "--out", str(tmp_path / "t.json"),
                              "--keep", keep])
        t_out = capsys.readouterr().out
        assert json.loads((tmp_path / "t.json").read_text()) == \
            json.loads((tmp_path / "j.json").read_text())
        assert t_out.replace("t.json", "j.json") == j_out
    # the module entry point
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-m", "rdpn6d_tpu_torch.tools.fuse_detections",
         *inputs, "--out", str(tmp_path / "m.json"), "--keep", "2"],
        cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads((tmp_path / "m.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


def test_strip_checkpoint_matches_jax(weights, orbax_ckpt, tmp_path,
                                      monkeypatch, capsys):
    from rdpn6d_tpu_torch.data.assets import synthetic_class_assets
    from rdpn6d_tpu_torch.engine.predictor import Predictor

    _jax_tool("strip_checkpoint", ["--ckpt-dir", orbax_ckpt, "--out",
                                   str(tmp_path / "jrel")], monkeypatch)
    (pkl,) = [f for f in os.listdir(tmp_path / "jrel")]
    assert pkl.startswith("model_7_")
    with open(tmp_path / "jrel" / pkl, "rb") as f:
        slim = pickle.load(f)
    capsys.readouterr()
    named = strip_checkpoint.main(["--ckpt-dir", weights[2], "--out",
                                   str(tmp_path / "rel")])
    assert capsys.readouterr().out.startswith(f"wrote {named}")
    import hashlib

    blob = open(named, "rb").read()
    assert os.path.basename(named) == \
        f"model_7_{hashlib.sha256(blob).hexdigest()[:8]}.pt"
    saved = torch.load(tmp_path / "rel" / "7" / "state.pt",
                       weights_only=True)
    assert saved["optimizer"] is None and saved["step"] == 7
    cfg = TConfig().apply_opts(OPTS)
    ref = state_dict_from_flax(cfg, slim["params"], slim["batch_stats"])
    assert set(saved["model"]) == set(ref)
    for k, v in ref.items():
        assert torch.equal(saved["model"][k], v), k
    # the release directory serves
    assets = synthetic_class_assets(cfg.head.num_regions, 300)
    pred = Predictor(cfg, assets, batch_size=2, dtype=torch.float32,
                     device="cpu", ckpt_dir=str(tmp_path / "rel"))
    full = Predictor(cfg, assets, batch_size=2, dtype=torch.float32,
                     device="cpu", ckpt_dir=weights[2])
    for a, b in zip(pred.model.state_dict().values(),
                    full.model.state_dict().values()):
        assert torch.equal(a, b)


def test_compute_fps_matches_jax(tree, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jrefs, "DATA_ROOT", tree)
    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    for tag, run in (("j", lambda a: _jax_tool("compute_fps", a,
                                               monkeypatch)),
                     ("t", compute_fps.main)):
        out = str(tmp_path / f"{tag}.pkl")
        run(["--dataset", "lm", "--counts", "4", "8", "32", "--out", out])
        # a subset run merges into the pickle
        run(["--dataset", "lm", "--counts", "12", "--objs", "ape", "--out",
             out])
    j = pickle.load(open(tmp_path / "j.pkl", "rb"))
    t = pickle.load(open(tmp_path / "t.pkl", "rb"))
    assert set(t) == set(j) == {str(o) for o in OBJS.values()}
    for oid in j:
        assert set(t[oid]) == set(j[oid])
        for k in j[oid]:
            assert t[oid][k].dtype == j[oid][k].dtype
            np.testing.assert_array_equal(t[oid][k], j[oid][k])


def test_convert_checkpoint_matches_jax(tmp_path, monkeypatch, capsys):
    """A reference-layout .pth of a full-width head (the JAX converter's
    6 head convs and 8x8 PnP map) at ResNet-18."""
    from rdpn6d_tpu_torch.models import RDPN, init_weights
    from rdpn6d_tpu_torch.engine.checkpoint import CheckpointManager

    opts = ["backbone.depth=18"]
    cfg = TConfig().apply_opts(opts)
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(2))
    sd = {f"module.{k}": v for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    pth = str(tmp_path / "ref.pth")
    torch.save({"state_dict": sd}, pth)
    _jax_tool("convert_checkpoint", ["--pth", pth, "--out",
                                     str(tmp_path / "flax.pkl"), "--depth",
                                     "18"], monkeypatch)
    with open(tmp_path / "flax.pkl", "rb") as f:
        flax = pickle.load(f)
    ref = state_dict_from_flax(cfg, flax["params"], flax["batch_stats"])
    port_cfg = tmp_path / "cfg.py"
    port_cfg.write_text("from rdpn6d_tpu_torch.config import Config\n\n\n"
                        "def get_config():\n    return Config()\n")
    for src in (["--pth", pth], ["--params-pkl", str(tmp_path / "flax.pkl")]):
        out = str(tmp_path / f"ckpt{len(src[0])}")
        convert_checkpoint.main([*src, "--out", out, "--depth", "18",
                                 "--config-file", str(port_cfg)])
        got = torch.load(os.path.join(out, "0", "state.pt"),
                         weights_only=True)["model"]
        for k, v in ref.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(got[k], v), k
        assert CheckpointManager(out).latest_step() == 0
    # a checkpoint of another model is refused
    with pytest.raises(SystemExit, match="does not fit"):
        convert_checkpoint.main(["--pth", pth, "--out",
                                 str(tmp_path / "bad"), "--depth", "34",
                                 "--config-file", str(port_cfg)])
