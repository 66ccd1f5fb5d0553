"""The eval slice end to end: a BOP-layout tree on disk -> records ->
decode -> preprocess and model -> evaluator -> tables, BOP19 CSV, recall
curves, BOP19 AR; the port's ``run_eval`` against the JAX package's on the
same tree and the same weights, plus the port's CLI, its refusals and its
checkpoint format.

Both sides run the tiny config in float32 on the CPU; the JAX side takes
the flax variables as its train state, the port a checkpoint written from
the same variables by ``checkpoint_from_params_pkl``. Tolerances: the CSV's
identity columns (scene_id, im_id, obj_id, score) equal; R and t within
1e-4 (float32 sums in other orders through the crop, trunk and head, as in
``test_torch_slice.py``); the per-object recall tables and the BOP19 AR
equal, since errors moved by ~1e-5 cross no threshold here. The CSV's time
column differs by design (the port does not pad batches).
"""

import json
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rdpn6d_tpu.data.refs as jrefs
import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.data.bop import Split as JSplit
from rdpn6d_tpu.data.bop import register_split as j_register
from rdpn6d_tpu.engine.eval_runner import run_eval as j_run_eval
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.models import dummy_batch
from rdpn6d_tpu.parallel import create_train_state as j_train_state
from rdpn6d_tpu.solver import build_optimizer as j_build_optimizer
from rdpn6d_tpu_torch import main as tmain
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data.bop import Split as TSplit
from rdpn6d_tpu_torch.data.bop import register_split as t_register
from rdpn6d_tpu_torch.data.synthetic import write_lm_tree
from rdpn6d_tpu_torch.engine.checkpoint import CheckpointManager
from rdpn6d_tpu_torch.engine.eval_runner import run_eval as t_run_eval
from rdpn6d_tpu_torch.models import RDPN as TRDPN
from rdpn6d_tpu_torch.models import init_weights
from rdpn6d_tpu_torch.parallel import TrainState, create_train_state
from rdpn6d_tpu_torch.utils.flax_params import checkpoint_from_params_pkl
from tests.test_torch_model import TINY, perturb

OPTS = TINY + ["backbone.rot_concat=true", "loss.num_pm_points=500"]
OBJS = {"ape": 1, "can": 5}
TARGETS = [{"scene_id": 1, "im_id": 0, "obj_id": 1, "inst_count": 1},
           {"scene_id": 1, "im_id": 2, "obj_id": 1, "inst_count": 1},
           {"scene_id": 5, "im_id": 1, "obj_id": 5, "inst_count": 1}]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """LM tree of two cube objects, 3 frames each, a BOP19 targets file,
    and the same splits registered in both packages."""
    root = str(tmp_path_factory.mktemp("lm_tree"))
    write_lm_tree(root, OBJS, frames_per_obj=3, seed=4)
    with open(os.path.join(root, "lm", "targets_two.json"), "w") as f:
        json.dump(TARGETS, f)
    for cls, reg in ((JSplit, j_register), (TSplit, t_register)):
        common = dict(objs=tuple(OBJS), filter_invalid=False,
                      per_obj_index="image_set/{obj}_test.txt")
        reg(cls("two_obj_test", "lm", "test", **common))
        reg(cls("two_obj_tgt", "lm", "test", targets_file="targets_two.json",
                **common))
    return root


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded, perturbed tiny flax variables: as a params pickle, and as a
    port checkpoint made from it."""
    cfg = JConfig().apply_opts(OPTS)
    variables = jax.jit(lambda key: JRDPN(cfg, dtype=jnp.float32).init(
        key, dummy_batch(cfg, 1), train=False))(jax.random.PRNGKey(5))
    params, stats = perturb(variables, 5)
    d = tmp_path_factory.mktemp("weights")
    pkl = str(d / "params.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"params": params, "batch_stats": stats}, f)
    ckpt = str(d / "ckpt")
    checkpoint_from_params_pkl(TConfig().apply_opts(OPTS), pkl, ckpt,
                               step=7)
    return params, stats, ckpt


def _read_csv(path):
    rows = open(path).read().strip().splitlines()[1:]
    ident, R, t = [], [], []
    for r in rows:
        f = r.split(",")
        ident.append(tuple(f[:4]))
        R.append(np.array(f[4].split(), float))
        t.append(np.array(f[5].split(), float))
    return ident, np.stack(R), np.stack(t)


def _both(tree, weights, tmp_path, monkeypatch, split, extra=()):
    monkeypatch.setattr(jrefs, "DATA_ROOT", tree)
    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    params, stats, ckpt = weights
    opts = OPTS + list(extra) + [f'train.output_dir="{tmp_path}"']
    jcfg = JConfig().apply_opts(opts)
    state = j_train_state(jcfg, {"params": params, "batch_stats": stats},
                          j_build_optimizer(jcfg, total_iters=1))
    j = j_run_eval(jcfg, ckpt_dir="", split_name=split, batch_size=2,
                   state=state, model=JRDPN(jcfg, dtype=jnp.float32),
                   csv_path=str(tmp_path / "jax.csv"))
    t = t_run_eval(TConfig().apply_opts(opts), ckpt_dir=ckpt,
                   split_name=split, batch_size=2,
                   csv_path=str(tmp_path / "port.csv"),
                   dtype=torch.float32, device="cpu")
    j_id, j_R, j_t = _read_csv(tmp_path / "jax.csv")
    t_id, t_R, t_t = _read_csv(tmp_path / "port.csv")
    assert t_id == j_id
    np.testing.assert_allclose(t_R, j_R, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_t, j_t, rtol=1e-4, atol=0)
    assert t["per_obj"] == j["per_obj"]
    assert t["mean"] == j["mean"]
    assert t["stats"]["n_rois"] == j["stats"]["n_rois"]
    return j, t


def test_run_eval_matches_jax(tree, weights, tmp_path, monkeypatch):
    j, t = _both(tree, weights, tmp_path, monkeypatch, "two_obj_test")
    assert set(t["per_obj"]) == set(OBJS)
    assert t["stats"]["n_rois"] == 6
    for name in ("recall_ad.csv", "recall_re.csv"):
        assert os.path.exists(tmp_path / "plots_two_obj_test" / name)


def test_coord_regression_eval_matches_jax(tree, weights, monkeypatch):
    """``coord_regression_eval`` (the ``--debug`` eval) against the JAX
    package's on the same weights in float32: the instance count equal,
    the masked L1 within 1e-4 relative (float32 through the network, and
    the labels' region ids may flip on 0.1% of the pixels), over whole
    batches and with a cut at ``max_batches``."""
    from rdpn6d_tpu.engine.eval_runner import coord_regression_eval as j_dbg
    from rdpn6d_tpu_torch.engine.eval_runner import \
        coord_regression_eval as t_dbg

    monkeypatch.setattr(jrefs, "DATA_ROOT", tree)
    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    params, stats, ckpt = weights
    jcfg, tcfg = JConfig().apply_opts(OPTS), TConfig().apply_opts(OPTS)
    state = j_train_state(jcfg, {"params": params, "batch_stats": stats},
                          j_build_optimizer(jcfg, total_iters=1))
    for bs, cut in ((4, 0), (2, 2)):
        j = j_dbg(jcfg, ckpt_dir="", split_name="two_obj_test",
                  batch_size=bs, max_batches=cut, state=state,
                  model=JRDPN(jcfg, dtype=jnp.float32))
        t = t_dbg(tcfg, ckpt_dir=ckpt, split_name="two_obj_test",
                  batch_size=bs, max_batches=cut, dtype=torch.float32,
                  device="cpu")
        assert t["n"] == j["n"] == (6 if not cut else 4)
        np.testing.assert_allclose(t["coord_l1"], j["coord_l1"], rtol=1e-4)


def test_run_eval_bop19_targets_match_jax(tree, weights, tmp_path,
                                          monkeypatch):
    j, t = _both(tree, weights, tmp_path, monkeypatch, "two_obj_tgt",
                 ['test.error_types="ad,mssd,mspd"'])
    assert t["stats"]["n_rois"] == len(TARGETS)
    assert set(t["bop19"]) == {"AR_mssd", "AR_mspd", "AR"}
    assert t["bop19"] == j["bop19"]


def test_live_bf16_eval_preprocesses_in_float32(tree, tmp_path,
                                               monkeypatch):
    """Evaluating a live model under bf16 autocast: the batch the model
    receives is the float32 preprocessing of its frames bit for bit (no
    op of the preprocessing runs in bf16), and within 1e-5 of the JAX
    package's, which preprocesses in float32 whatever the model's dtype
    (the tolerance of ``test_torch_slice.py``: the TPU path crops by
    matmul, the port by gather)."""
    from rdpn6d_tpu.data.pipeline import preprocess_rois_grouped as j_grouped
    from rdpn6d_tpu_torch.data import pipeline

    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    opts = OPTS + [f'train.output_dir="{tmp_path}"']
    cfg = TConfig().apply_opts(opts)
    live = init_weights(TRDPN(cfg), torch.Generator().manual_seed(3))
    grouped = pipeline.preprocess_rois_grouped
    inputs, seen = [], []

    def recording(cfg_, frames, rois, *a, **kw):
        inputs.append((frames, rois))
        return grouped(cfg_, frames, rois, *a, **kw)

    monkeypatch.setattr(pipeline, "preprocess_rois_grouped", recording)
    hook = live.register_forward_pre_hook(
        lambda mod, args: seen.append({k: v.clone()
                                       for k, v in args[0].items()}))
    try:
        t_run_eval(cfg, ckpt_dir="", split_name="two_obj_test",
                   batch_size=2, dtype=torch.bfloat16, model=live)
    finally:
        hook.remove()
    assert len(seen) == len(inputs) == 3
    jcfg = JConfig().apply_opts(opts)
    for (frames, rois), batch in zip(inputs, seen):
        ref = grouped(cfg, frames, rois)
        assert batch.keys() == ref.keys()
        for k, v in ref.items():
            assert v.dtype == batch[k].dtype and torch.equal(batch[k], v), k
        j = j_grouped(jcfg, {k: jnp.asarray(v.numpy())
                             for k, v in frames.items()},
                      {k: jnp.asarray(v.numpy()) for k, v in rois.items()},
                      jax.random.PRNGKey(0), train=False)
        for k in ("roi_img", "roi_coord_2d", "roi_cam", "resize_ratio"):
            np.testing.assert_allclose(batch[k].numpy(), np.asarray(j[k]),
                                       rtol=1e-6, atol=1e-5, err_msg=k)


def test_main_eval_only_cpu(tree, weights, tmp_path, monkeypatch):
    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    _, _, ckpt = weights
    out = tmp_path / "run"
    os.makedirs(out)
    os.symlink(ckpt, out / "ckpt")
    res = tmain.main([
        "--config-file", "rdpn6d_tpu_torch/configs/lm13.py", "--eval-only",
        "--device", "cpu", "--opts", *OPTS, f'train.output_dir="{out}"',
        'data.test_datasets=["two_obj_test"]'])
    assert res["two_obj_test"]["stats"]["n_rois"] == 6
    csv = (out / "two_obj_test_bop19.csv").read_text().splitlines()
    assert len(csv) == 7 and csv[0].startswith("scene_id,im_id,obj_id")
    assert (out / "plots_two_obj_test" / "recall_adi.csv").exists()
    log = (out / "log.txt").read_text()
    assert "MEAN" in log and "ape" in log and "can" in log
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["data"]["test_datasets"] == ["two_obj_test"]


def test_eval_refusals(tree, weights, tmp_path, monkeypatch):
    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    cfg = TConfig().apply_opts(OPTS)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        t_run_eval(cfg, ckpt_dir=str(tmp_path / "none"),
                   split_name="two_obj_test", device="cpu")
    base = ["--config-file", "rdpn6d_tpu_torch/configs/lm13.py"]
    # the flat train path and --debug, once refused, run: 6 records at 2
    # ROIs a step, then the debug eval of the 6 test instances on the
    # weights' checkpoint (held to the JAX package's below)
    out = tmp_path / "run"
    os.makedirs(out)
    flat = ["--device", "cpu", "--opts", *OPTS, 'backbone.pretrained=""',
            f'train.output_dir="{out}"', "data.grouped_train=false",
            'data.train_datasets=["two_obj_test"]', "solver.ims_per_batch=2",
            "solver.total_epochs=1", "train.eval_period=0"]
    assert tmain.main(base + flat).step == 3
    shutil.rmtree(out / "ckpt")
    os.symlink(weights[2], out / "ckpt")
    res = tmain.main(base + ["--eval-only", "--debug", "--device", "cpu",
                             "--opts", *OPTS, f'train.output_dir="{out}"',
                             'data.test_datasets=["two_obj_test"]'])
    assert res["two_obj_test"]["n"] == 6
    assert np.isfinite(res["two_obj_test"]["coord_l1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmain.main(base + ["--eval-only", "--opts",
                               f'train.output_dir="{tmp_path}"'])
    with pytest.raises(NotImplementedError, match="use_pnp"):
        t_run_eval(cfg.apply_opts(["test.use_pnp=true"]), ckpt_dir="",
                   split_name="two_obj_test", device="cpu")
    with pytest.raises(ValueError, match="int8='foo'"):
        t_run_eval(cfg.apply_opts(['test.int8="foo"']), ckpt_dir="",
                   split_name="two_obj_test", device="cpu",
                   allow_random_init=True)


def test_checkpoint_manager_round_trip(tmp_path):
    cfg = TConfig().apply_opts(OPTS)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None
    os.makedirs(tmp_path / "ckpt" / "9")   # a foreign (orbax) step
    states = []
    for step in (1, 2, 3):
        model = init_weights(TRDPN(cfg), torch.Generator().manual_seed(step))
        state = create_train_state(cfg, model)
        model(_batch(cfg)).get("trans").sum().backward()
        state.optimizer.step()             # optimizer state to carry
        mgr.save(step, state, extra={"it": step})
        states.append(state)
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "3", "9"]
    fresh = create_train_state(cfg, TRDPN(cfg))
    fresh, extra = mgr.restore(fresh)
    assert extra == {"it": 3} and fresh.step == 3
    for k, v in states[-1].model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    want = states[-1].optimizer.state_dict()["state"]
    got = fresh.optimizer.state_dict()["state"]
    assert want.keys() == got.keys()
    for i in want:
        for k, v in want[i].items():
            assert torch.equal(torch.as_tensor(got[i][k]),
                               torch.as_tensor(v)), (i, k)
    old, _ = mgr.restore(TrainState(TRDPN(cfg), None), step=2)
    assert old.step == 2
    assert mgr.resume_or_load(fresh, resume=False)[1] == 0
    assert mgr.resume_or_load(fresh, resume=True)[1] == 3


def _batch(cfg):
    from tests.test_torch_model import make_batch

    return {k: torch.from_numpy(v) for k, v in make_batch(cfg, 2).items()}
