"""``tools.rehearse_protocol`` against the JAX package's
``tools/rehearse_protocol.py``, loaded from its file:

  * the helpers: ``parse_bop19_line`` and ``rescore_consistent`` give the
    JAX tool's answers on the same inputs;
  * the chain: with every step stubbed (``subprocess.run`` recording the
    commands and writing what each step leaves), the same steps in the
    same order with the same arguments for each flag set, the JAX tool's
    scripts replaced by the port's modules, its config by the port's
    copy and ``--platform`` by ``--device`` on the train, eval and score
    steps; the same summary and the same ``--gate`` verdict;
  * the chain for real, as ``tests/test_rehearsal.py`` checks the JAX
    one, at tiny widths for 1 epoch with ``--device cpu``: every step
    exits 0, the summary's numbers are finite and in range, the rescore
    ran, and every stage's files exist;
  * ``RDPN6D_LAUNCH_LOG``: each process of a chain appends its launches.
"""

import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from rdpn6d_tpu_torch.tools import rehearse_protocol as rp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_OPTS = [
    "backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
    "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
    "data.out_res=16", "loss.num_pm_points=64", "solver.ims_per_batch=8",
    "solver.optimizer=adamw", "solver.warmup_iters=10",
    'test.error_types="ad,adi,re,te,proj,mssd,mspd"',
]


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_rehearse_protocol",
        os.path.join(ROOT, "tools", "rehearse_protocol.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("out", [
    "noise\nBOP19: {'AR_mssd': 0.83, 'AR_mspd': 0.91, 'AR': 0.87}\n",
    "no marker here",
    "BOP19: {'AR': 0.1}\nBOP19: {'AR': 0.2, 'AR_vsd': 0.3}\n",
    "  BOP19: {'AR': 0.5}\n",
])
def test_parse_bop19_line_matches_jax(out):
    assert rp.parse_bop19_line(out) == jax_tool().parse_bop19_line(out)


@pytest.mark.parametrize("est,rescore", [
    ({"AR_mssd": 0.84, "AR_mspd": 0.90, "AR": 0.87, "AR_vsd": 0.5},
     {"AR_mssd": 0.83, "AR_mspd": 0.91, "AR": 0.87}),
    ({"AR_mssd": 0.84, "AR_mspd": 0.90, "AR": 0.87},
     {"AR_mssd": 0.10, "AR_mspd": 0.91, "AR": 0.50}),
    ({"AR": 0.87}, {}),
    ({}, {"AR": 0.2}),
    ({"AR": 0.30}, {"AR": 0.35}),
    ({"AR": 0.30}, {"AR": 0.3501}),
])
def test_rescore_consistent_matches_jax(est, rescore):
    assert rp.rescore_consistent(est, rescore) \
        == jax_tool().rescore_consistent(est, rescore)


def fake_steps(calls, ad_10):
    """``subprocess.run`` for the chain: records each command and leaves
    what the step would."""
    def run(cmd, **kw):
        calls.append((list(cmd), kw["env"]["RDPN6D_DATA_ROOT"]))
        out = ""
        if "--json" in cmd:
            with open(cmd[cmd.index("--json") + 1], "w") as f:
                json.dump({"mean": {"ad_10": ad_10, "te_2": 50.0,
                                    "re_5": 40.0, "adi_10": 1.0,
                                    "re_10": 2.0},
                           "per_obj": {"ape": {"ad_10": ad_10}},
                           "bop19": {"AR_mssd": 0.6, "AR_mspd": 0.7,
                                     "AR": 0.65}}, f)
        if "--bop19" in cmd:
            out = "BOP19: {'AR_mssd': 0.61, 'AR_mspd': 0.7, 'AR': 0.655}\n"
        return types.SimpleNamespace(returncode=0, stdout=out, stderr="")
    return run


def port_form(cmd):
    """A JAX chain command in the port's form: the scripts as the port's
    modules, the config as the port's copy."""
    out = list(cmd)
    if out[1].startswith("tools/"):
        name = out[1][len("tools/"):-len(".py")]
        out[1:2] = ["-m", f"rdpn6d_tpu_torch.tools.{name}"]
    elif out[1:3] == ["-m", "rdpn6d_tpu.main"]:
        out[2] = "rdpn6d_tpu_torch.main"
    return [rp.CONFIG if a == "configs/mini.py" else a for a in out]


@pytest.mark.parametrize("flags", [
    [], ["--gate"], ["--obj", "ape", "--eval-train"],
    ["--skip-make", "--resume"], ["--skip-train", "--epochs", "3"]])
def test_chain_matches_jax(flags, tmp_path, monkeypatch, capsys):
    base = ["--root", str(tmp_path / "data"), "--run", str(tmp_path / "run"),
            "--opts", "a.b=1"]
    jmod = jax_tool()
    for ad_10 in (99.0, 10.0):
        j_calls, t_calls = [], []
        monkeypatch.setattr(jmod.subprocess, "run",
                            fake_steps(j_calls, ad_10))
        monkeypatch.setattr(sys, "argv", ["rehearse_protocol", *base,
                                          *flags, "--platform", "cpu"])
        try:
            jmod.main()
            j_verdict = "passed"
        except SystemExit as e:
            j_verdict = str(e)
        j_text = capsys.readouterr().out
        monkeypatch.setattr(subprocess, "run", fake_steps(t_calls, ad_10))
        try:
            rp.main([*base, *flags, "--device", "cpu"])
            t_verdict = "passed"
        except SystemExit as e:
            t_verdict = str(e)
        t_text = capsys.readouterr().out
        assert t_verdict == j_verdict
        assert ("GATE" in t_verdict) == ("--gate" in flags and ad_10 < 95)
        assert len(t_calls) == len(j_calls) >= 5
        for (tc, t_root), (jc, j_root) in zip(t_calls, j_calls):
            assert t_root == j_root
            jc = port_form(jc)
            if tc[2] in ("rdpn6d_tpu_torch.main",
                         "rdpn6d_tpu_torch.tools.eval_split",
                         "rdpn6d_tpu_torch.tools.score_csv"):
                at = tc.index("--device")
                assert tc[at + 1] == "cpu"
                tc = tc[:at] + tc[at + 2:]
            assert tc == jc
        summary = [ln for ln in t_text.splitlines()
                   if ln.startswith("REHEARSAL_SUMMARY")]
        assert summary == [ln for ln in j_text.splitlines()
                           if ln.startswith("REHEARSAL_SUMMARY")]


def test_chain_runs_on_cpu(tmp_path):
    root = str(tmp_path / "minibop")
    run_dir = str(tmp_path / "run")
    proc = subprocess.run(
        [sys.executable, "-m", "rdpn6d_tpu_torch.tools.rehearse_protocol",
         "--root", root, "--run", run_dir, "--n-train", "4", "--n-test",
         "2", "--epochs", "1", "--device", "cpu", "--opts", *SMALL_OPTS],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, \
        proc.stdout[-3000:] + "\n" + proc.stderr[-3000:]
    with open(os.path.join(run_dir, "rehearsal_summary.json")) as f:
        summary = json.load(f)
    for k in ("gt_ad_10", "gt_te_2", "est_ad_10"):
        assert 0.0 <= summary[k] <= 100.0, (k, summary)
    assert summary["rescore_ran"]
    assert set(summary["gt_per_obj_ad_10"]) <= {"ape", "can", "driller"}
    bop = summary["est_bop19"]
    for k in ("AR_mssd", "AR_mspd", "AR"):
        assert 0.0 <= bop[k] <= 1.0, bop
    for f_ in ("gt_bbox.csv", "est_bbox.csv", "metrics_gt_bbox.json",
               "metrics_est_bbox.json", "train_log.txt", "rescore_log.txt",
               "eval_gt_log.txt", "eval_est_log.txt"):
        assert os.path.exists(os.path.join(run_dir, f_)), f_
    assert os.listdir(os.path.join(run_dir, "ckpt"))
    # the BOP CSV covers the test targets with finite poses
    rows = open(os.path.join(run_dir, "gt_bbox.csv")).read().splitlines()
    assert len(rows) >= 3
    for r in rows[1:]:
        f = r.split(",")
        assert int(f[0]) == 92
        assert np.isfinite(np.array(f[4].split(), float)).all()
    # the dataset's stages: models, FPS keypoints, xyz crops
    lm = os.path.join(root, "lm")
    assert os.path.exists(os.path.join(lm, "models", "fps_points.pkl"))
    assert any(f.endswith(".pkl") for _, _, fs in os.walk(
        os.path.join(lm, "train")) for f in fs)


def test_launch_log_at_exit(tmp_path):
    """A process started with ``RDPN6D_LAUNCH_LOG`` appends its argv and
    launch counts to that file when it exits (phase 18(c) sums a chain's
    subprocesses so); without it, nothing is written."""
    log = str(tmp_path / "launches.jsonl")
    code = ("import sys; from rdpn6d_tpu_torch.ops import cuda_build as c; "
            "c.count_launch('roi_crop'); c.count_launch('roi_crop'); "
            "c.count_launch('min_dist2'); sys.exit(int(sys.argv[1]))")
    for rc in (0, 3):
        proc = subprocess.run([sys.executable, "-c", code, str(rc)],
                              cwd=ROOT, env=dict(os.environ,
                                                 RDPN6D_LAUNCH_LOG=log))
        assert proc.returncode == rc
    env = {k: v for k, v in os.environ.items() if k != "RDPN6D_LAUNCH_LOG"}
    subprocess.run([sys.executable, "-c", code, "0"], cwd=ROOT, env=env,
                   check=True)
    with open(log) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["launches"] for ln in lines] == \
        [{"roi_crop": 2, "min_dist2": 1}] * 2
    assert [ln["argv"] for ln in lines] == [["-c", "0"], ["-c", "3"]]
