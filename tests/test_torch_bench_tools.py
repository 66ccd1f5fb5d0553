"""The seven ``bench_*`` tools of the port
(``python -m rdpn6d_tpu_torch.tools.<name>``) on the CPU.

Against the JAX package's ``tools/<name>.py`` (loaded from its file, run
with a patched ``sys.argv``, its printed JSON parsed):

* ``bench_score_scale`` at ``--frames 10 --objs 2 --pts 50
  --ests-per-target 2``: the counts equal, the ARs and ``mean_ad_10``
  within 1e-9 (the same numpy drawn in the same order; the port's
  Rodrigues is the closed form, OpenCV's differs by float64 rounding,
  far from any recall threshold here);
* ``bench_input`` on one tiny ``make_mini_bop`` tree: each mode's
  ``mb_per_pose`` equal to the JAX tool's 2 decimals (the two loaders'
  batches are byte-equal, ``test_torch_train_data.py``).

Within the port: every tool runs end to end at a tiny width and prints
the JAX tool's keys (``bench_layout``, whose JAX tool prints text, its
own); ``bench_layout``'s three forms agree in float32 within 1e-5 of the
output's largest magnitude (the CPU convolution sums in another order on
another layout); ``bench_train``'s FLOP count is positive and its MFU
null on the CPU; the peak table names the H100 and the JAX tool's TPU
peak appears nowhere in the port.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import rdpn6d_tpu.data.refs as jrefs
import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu_torch.config import Config
from rdpn6d_tpu_torch.tools import (
    bench_bn,
    bench_cli_step,
    bench_input,
    bench_int8,
    bench_layout,
    bench_score_scale,
    bench_train,
    make_mini_bop,
)
from rdpn6d_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16"]
QUICK = ["--iters", "1", "--warmup", "1", "--device", "cpu"]

# the keys of the JAX tools' JSON lines (tools/<name>.py)
TRAIN_KEYS = {"metric", "batch", "ms_per_step", "value", "unit", "tflops",
              "mfu_pct"}
DECOMPOSE_KEYS = {"metric", "batch", "ms"}
GROUPED_KEYS = {"metric", "rois", "frames", "ms_per_step", "poses_per_sec",
                "mfu_pct"}
INT8_KEYS = {"mode", "batch", "ms_per_batch", "poses_per_sec", "vs_bf16"}
BN_KEYS = {"module", "mode", "batch", "ms", "mfu_pct"}
INPUT_KEYS = {"metric", "batch", "ms_per_batch", "value", "unit",
              "mb_per_pose"}
CLI_KEYS = {"batch", "sync_ms", "sync_total_ms", "pipelined_ms_per_iter",
            "pipelining_recovery_ms"}
CLI_STAGES = {"host_produce", "cache_stack_h2d", "preprocess", "train_step",
              "loss_readback"}
SCORE_KEYS = {"frames", "targets", "estimates", "bop19_s", "ars",
              "recall_tables_s", "mean_ad_10"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax_tool(name, argv, monkeypatch):
    """Run ``tools/<name>.py``'s main with ``argv``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    return mod.main()


def _json_lines(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def _printed(capsys, lines: list[dict]) -> None:
    """What a tool printed is the JSON of what it returned."""
    assert _json_lines(capsys.readouterr().out) == \
        json.loads(json.dumps(lines))


@pytest.fixture(scope="module")
def mini_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("minibop"))
    make_mini_bop.make(root, n_train=4, n_test=2, seed=0)
    return root


@pytest.fixture
def roots(mini_tree, monkeypatch):
    monkeypatch.setattr(jrefs, "DATA_ROOT", mini_tree)
    monkeypatch.setattr(trefs, "DATA_ROOT", mini_tree)
    return mini_tree


def test_score_scale_matches_jax_tool(capsys, monkeypatch):
    argv = ["--frames", "10", "--objs", "2", "--pts", "50",
            "--ests-per-target", "2"]
    _jax_tool("bench_score_scale", argv, monkeypatch)
    ref = _json_lines(capsys.readouterr().out)[-1]
    ours = bench_score_scale.main(argv + ["--device", "cpu"])
    _printed(capsys, [ours])
    assert set(ours) == set(ref) == SCORE_KEYS
    for k in ("frames", "targets", "estimates"):
        assert ours[k] == ref[k], k
    assert (ours["targets"], ours["estimates"]) == (20, 40)
    assert set(ours["ars"]) == set(ref["ars"])
    for k, v in ref["ars"].items():
        assert ours["ars"][k] == pytest.approx(v, abs=1e-9), k
    assert ours["mean_ad_10"] == pytest.approx(ref["mean_ad_10"], abs=1e-9)
    assert ours["bop19_s"] > 0 and ours["recall_tables_s"] > 0


def test_input_bytes_match_jax_tool(roots, capsys, monkeypatch):
    argv = ["--batch", "4", "--iters", "2", "--warmup", "1"]
    _jax_tool("bench_input", argv, monkeypatch)
    ref = _json_lines(capsys.readouterr().out)
    ours = bench_input.main(argv + ["--device", "cpu"])
    _printed(capsys, ours)
    assert [ln["metric"] for ln in ours] == [ln["metric"] for ln in ref]
    for a, b in zip(ours, ref):
        assert set(a) == set(b) == INPUT_KEYS
        assert round(a["mb_per_pose"], 2) == b["mb_per_pose"], a["metric"]
        assert a["value"] > 0
    # the grouped path ships each frame once, in its compact dtypes
    assert ours[1]["mb_per_pose"] < ours[0]["mb_per_pose"]


def test_cli_step_runs(roots, capsys):
    out = bench_cli_step.main(["--batch", "4", "--iters", "2", "--device",
                               "cpu", "--opts", *TINY])
    text = capsys.readouterr().out
    assert "records," in text and "warm epoch:" in text
    assert json.loads(text[text.index("{"):]) == json.loads(json.dumps(out))
    assert set(out) == CLI_KEYS and set(out["sync_ms"]) == CLI_STAGES
    assert all(v >= 0 for v in out["sync_ms"].values())
    assert out["sync_total_ms"] == pytest.approx(sum(
        out["sync_ms"].values()))
    assert out["pipelined_ms_per_iter"] > 0


@pytest.mark.parametrize("flags", [["--decompose"], ["--remat"]])
def test_train_runs(flags, capsys):
    lines = bench_train.main(["--batch-sizes", "2", *QUICK, *flags,
                              "--opts", *TINY])
    _printed(capsys, lines)
    step, parts = lines[0], lines[1:]
    assert set(step) == TRAIN_KEYS and step["batch"] == 2
    assert step["metric"].endswith("+remat)" if "--remat" in flags
                                   else "ranger)")
    # FLOPs counted, no card: no MFU
    assert step["tflops"] > 0 and step["mfu_pct"] is None
    if "--decompose" in flags:
        assert [p["metric"] for p in parts] == [
            f"decompose/{t}" for t in ("model_fwd_eval", "model_fwd_train",
                                       "fwd_only", "fwd_bwd",
                                       "optimizer_only")]
        assert all(set(p) == DECOMPOSE_KEYS and p["ms"] > 0 for p in parts)
    else:
        assert not parts


def test_train_grouped_ab_runs(capsys):
    lines = bench_train.main(["--batch-sizes", "5", *QUICK, "--grouped-ab",
                              "--opts", *TINY])
    _printed(capsys, lines)
    assert [ln["metric"].split()[0] for ln in lines] == [
        "grouped_ab/two_program", "grouped_ab/fused"]
    for ln in lines:
        # the JAX tool's keys and the spread of the alternated steps
        assert set(ln) == GROUPED_KEYS | {"ms_min", "ms_max"}
        assert (ln["rois"], ln["frames"]) == (5, 1)
        assert ln["mfu_pct"] is None and ln["poses_per_sec"] > 0
        assert ln["ms_min"] <= ln["ms_per_step"] <= ln["ms_max"]


def test_flops_counted_and_peak_by_card_name():
    cfg = Config().apply_opts(TINY)
    state, step, batch_at = bench_train.setup(cfg, 2, torch.device("cpu"))
    fwd = profiling.count_flops(lambda: state.model(batch_at(0)))
    both = profiling.count_flops(lambda: step(state, batch_at(1)))
    # the backward pass counts about twice the forward's
    assert 0 < 2 * fwd < both < 4 * fwd
    assert profiling.bf16_peak_flops("cpu") is None
    assert profiling.BF16_PEAK_FLOPS["NVIDIA H100 80GB HBM3"] == 989.4e12


def test_remat_flops_leave_out_the_recompute():
    """Under ``--remat`` the MFU's FLOPs are the step's without remat: the
    recompute is counted by ``count_flops`` but is not model work."""
    plain, remat = (Config().apply_opts(TINY + [f"solver.remat={r}"])
                    for r in ("false", "true"))
    state, step, batch_at = bench_train.setup(plain, 2, torch.device("cpu"))
    want = profiling.count_flops(lambda: step(state, batch_at(0)))
    state, step, batch_at = bench_train.setup(remat, 2, torch.device("cpu"))
    hardware = profiling.count_flops(lambda: step(state, batch_at(0)))
    got = bench_train.model_flops(state, lambda: step(state, batch_at(0)))
    assert got == want < hardware
    assert state.model.cfg.solver.remat


def test_no_tpu_peak_in_the_port():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "rdpn6d_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert "197e12" not in fh.read(), f


def test_int8_runs(capsys):
    lines = bench_int8.run(bench_int8.parse_args(["--batch", "2", *QUICK]),
                           cfg=Config().apply_opts(TINY))
    _printed(capsys, lines)
    assert [ln["mode"] for ln in lines] == ["bf16", "head", "head-static",
                                            "all", "all-static"]
    assert all(set(ln) == INT8_KEYS for ln in lines)
    assert lines[0]["vs_bf16"] == 1.0


def test_bn_runs(capsys):
    lines = bench_bn.run(bench_bn.parse_args(["--batch", "2", "--s2d",
                                              *QUICK]),
                         depth=18, res=64, head_res=8, head_in=64,
                         num_filters=32)
    _printed(capsys, lines)
    assert [(ln["module"], ln["mode"]) for ln in lines] == [
        (m, t) for m in ("trunk_r18_64px", "trunk_r18_64px_s2d",
                         "trunk_r18_64px_rgb", "trunk_r18_64px_rgb_s2d",
                         "dense_head_16px") for t in ("eval", "train")]
    assert all(set(ln) == BN_KEYS and ln["mfu_pct"] is None
               for ln in lines)


def test_layout_forms_agree_in_float32(capsys):
    lines = bench_layout.run(
        bench_layout.parse_args(["--batch", "2", "--iters", "2", *QUICK[2:]]),
        depth=18, res=64, dtype=torch.float32)
    _printed(capsys, lines)
    assert [ln["form"] for ln in lines] == ["a", "b", "c"]
    assert all(set(ln) == {"form", "layout", "batch", "ms_per_fwd",
                           "max_abs_diff_vs_a"} for ln in lines)
    from rdpn6d_tpu_torch.models.resnet import ResNetTrunk

    torch.manual_seed(0)
    ref = ResNetTrunk(18).eval()
    # the tool's first input, and its module
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 6)
                         .astype(np.float32)).permute(0, 3, 1, 2)[:, :3]
    with torch.no_grad():
        scale = float(ref(x).abs().max())
    assert lines[0]["max_abs_diff_vs_a"] == 0.0
    assert all(ln["max_abs_diff_vs_a"] <= 1e-5 * scale for ln in lines)


def test_cuda_is_the_default_device():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_layout.main(["--batch", "1", "--iters", "1"])
