"""``tools.overfit_synth``'s scenes and ``tools.int8_gate_sweep``'s table
against the JAX package's ``tools/overfit_synth.py`` and
``tools/int8_gate_sweep.py``, loaded from their files:

  * the axis-angle rotation the views are drawn with
    (``data/synthetic._rodrigues``) against ``cv2.Rodrigues``, within
    1e-6;
  * ``build_scenes`` of the cube and of the tetrahedron at seed 0 (the
    tool's ``--small`` config, 480x640 views), the JAX DZI boxes injected:
    the views' poses and model points equal, and the preprocessed batch
    within the preprocessing tests' bounds (``test_torch_flat_train.py``:
    colour and 2-D coordinates within 5e-5, the depth-derived channels
    within 1e-3, masks equal, region ids equal on >= 0.999 of the pixels
    and coordinates within 1e-5 there, the pose targets within 1e-6). The
    tetrahedron is rendered by each package's own rasterizer build
    (``test_torch_vsd.py``: covered pixels equal, depth within 1e-6
    relative on >= 99.9% of them), its colour from the rendered xyz;
  * the sweep's RESULT parser, per-seed runs and aggregation on canned
    ``overfit_synth`` stdout (nan, inf and a missing tag among it): the
    same printed table and the same JSON, and the same command but the
    module form and ``--device``.

``test_torch_overfit_train.py`` trains the tool's ``--small`` model.
"""

import importlib.util
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data.synthetic import _rodrigues
from rdpn6d_tpu_torch.tools import int8_gate_sweep, overfit_synth
from tests.test_torch_flat_train import assert_labels_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VIEWS = 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_opts(tmp_path):
    args = overfit_synth.parse_args(["--small", "--out", str(tmp_path)])
    return overfit_synth.config_opts(args)


@pytest.mark.parametrize("seed", range(6))
def test_rodrigues_matches_cv2(seed):
    import cv2

    rng = np.random.RandomState(seed)
    rvec = rng.randn(3) * [0.8, 2.0, 1e-3, 1e-9, np.pi, 4.0][seed]
    np.testing.assert_allclose(_rodrigues(rvec),
                               cv2.Rodrigues(rvec)[0], rtol=0, atol=1e-6)


def test_cube_symmetries_match_jax():
    np.testing.assert_array_equal(overfit_synth.cube_sym_rotations(),
                                  jax_tool("overfit_synth")
                                  ._cube_sym_rotations())


@pytest.mark.parametrize("mesh", ["cube", "tetra"])
def test_build_scenes_matches_jax(mesh, tmp_path):
    opts = small_opts(tmp_path)
    jcfg = JConfig().apply_opts(opts)
    tcfg = TConfig().apply_opts(opts)
    j_batch, j_pts, j_poses = jax_tool("overfit_synth").build_scenes(
        jcfg, N_VIEWS, jcfg.head.num_regions, seed=0, mesh=mesh)
    j = jax.device_get(j_batch)
    t_batch, t_pts, t_poses = overfit_synth.build_scenes(
        tcfg, N_VIEWS, tcfg.head.num_regions, seed=0, mesh=mesh,
        center_scale=(torch.tensor(np.asarray(j["bbox_center"])),
                      torch.tensor(np.asarray(j["scale"]))))
    np.testing.assert_array_equal(t_pts, j_pts)
    for (tR, tt), (jR, jt) in zip(t_poses, j_poses):
        np.testing.assert_allclose(tR, jR, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tt, jt)
    t = {k: v.cpu() for k, v in t_batch.items()}
    assert t["roi_img"].shape == (N_VIEWS, 64, 64, 6)
    assert_labels_close(t, {k: np.asarray(v) for k, v in j.items()})
    # the views' objects are in the crops: every ROI has a visible mask
    assert (t["roi_mask_visib"].flatten(1).sum(1) > 0).all()


SEED_OUT = {
    0: ("RESULT[bf16] ad_10=100.0 re_5=93.8 te_2=100.0 AUCad=98.1\n"
        "RESULT[int8-all] ad_10=62.5 re_5=12.5 te_2=87.5 AUCad=80.2\n"
        "RESULT[int8-head-static] ad_10=100.0 re_5=87.5 te_2=100.0 "
        "AUCad=97.7\n"),
    1: ("noise RESULT[bf16] ad_10=93.8 re_5=100.0 te_2=nan AUCad=96.0\n"
        "RESULT[int8-head-static] ad_10=inf re_5=75.0 te_2=93.8 "
        "AUCad=95.5\n"),
    2: ("RESULT[bf16] ad_10=87.5 re_5=81.2 te_2=100.0 AUCad=95.1\n"
        "RESULT[int8-all] ad_10=50.0 re_5=0.0 te_2=81.2 AUCad=77.7\n"
        "table lines that are no RESULT\n"
        "RESULT[int8-head-static] ad_10=93.8 re_5=81.2 te_2=100.0 "
        "AUCad=96.9\n"),
}


def canned_run(calls):
    def fake(cmd, **kw):
        calls.append(cmd)
        seed = int(cmd[cmd.index("--seed") + 1])
        return types.SimpleNamespace(returncode=0, stdout=SEED_OUT[seed],
                                     stderr="")
    return fake


def test_sweep_matches_jax(tmp_path, monkeypatch, capsys):
    jmod = jax_tool("int8_gate_sweep")
    assert jmod.RESULT_RE.pattern == int8_gate_sweep.RESULT_RE.pattern
    j_calls, t_calls = [], []
    monkeypatch.setattr(jmod.subprocess, "run", canned_run(j_calls))
    j_out = str(tmp_path / "j.json")
    monkeypatch.setattr(sys, "argv", [
        "int8_gate_sweep", "--seeds", "3", "--out", j_out, "--workdir",
        str(tmp_path / "w")])
    jmod.main()
    j_text = capsys.readouterr().out
    monkeypatch.setattr(subprocess, "run", canned_run(t_calls))
    t_out = str(tmp_path / "t.json")
    agg = int8_gate_sweep.main(["--seeds", "3", "--out", t_out,
                                "--workdir", str(tmp_path / "w"),
                                "--device", "cpu"])
    t_text = capsys.readouterr().out
    assert t_text.replace(t_out, "OUT") == j_text.replace(j_out, "OUT")
    assert "WARNING: int8-all present in only 2/3 seeds" in t_text
    with open(j_out) as f:
        j_json = f.read()
    with open(t_out) as f:
        t_json = f.read()
    assert t_json == j_json
    assert json.loads(t_json, parse_constant=float)["aggregate"] \
        .keys() == agg.keys() == {"bf16", "int8-all", "int8-head-static"}
    assert np.isnan(agg["bf16"]["te_2"]["mean"])
    assert agg["int8-head-static"]["ad_10"]["max"] == float("inf")
    # the same overfit run a seed, as the port's module, on --device
    assert len(t_calls) == len(j_calls) == 3
    for tc, jc in zip(t_calls, j_calls):
        assert tc[1:3] == ["-m", "rdpn6d_tpu_torch.tools.overfit_synth"]
        assert jc[1] == "tools/overfit_synth.py"
        assert tc[3:-2] == jc[2:] and tc[-2:] == ["--device", "cpu"]
