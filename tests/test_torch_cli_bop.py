"""The BOP experiment configs with real training frames end to end on the
CPU: ``main --device cpu`` at tiny widths trains a few iterations and
evaluates on ``write_bop_tree`` trees of ycbv, tless (540x720 frames) and
tudl, plus one ``configs/so.py`` variant (ycbv, one object).

What it holds: ycbv's filtered train records equal the JAX package's
``load_train_records`` (every instance under 20% visible dropped, and
some are), its symmetric PM loss meets a non-identity symmetry bank, a
TRAIN2 iteration takes its labels from the depth surface and a real one
from the GT crops, and the eval writes the AUCadd, AUCadi, AUCad, ad and
ABSad columns; the port's ``run_eval`` on ycbv's keyframes equals the JAX
package's on the same tree and weights (the tolerance of
``test_torch_eval_runner.py``: R and t within 1e-4, tables equal); tless
reads 540x720 frames and scales the MSPD thresholds by 720 / 640, and the
AR recomputed from the written CSV equals the run's; tudl and the SO
variant train and score.
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
from rdpn6d_tpu.data.loader import load_train_records as j_records
from rdpn6d_tpu.engine.eval_runner import run_eval as j_run_eval
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.models import dummy_batch
from rdpn6d_tpu.parallel import create_train_state as j_train_state
from rdpn6d_tpu.solver import build_optimizer as j_build_optimizer
from rdpn6d_tpu_torch import main as tmain
from rdpn6d_tpu_torch.config import load_config
from rdpn6d_tpu_torch.data.loader import load_train_records as t_records
from rdpn6d_tpu_torch.data.synthetic import write_bg_pool, write_bop_tree
from rdpn6d_tpu_torch.engine import eval_runner
from rdpn6d_tpu_torch.utils.flax_params import checkpoint_from_params_pkl
from tests.test_torch_model import TINY, perturb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = TINY + ["loss.num_pm_points=500", "solver.ims_per_batch=4",
               "train.log_period=1", 'backbone.pretrained=""']


def config_path(name):
    return os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", f"{name}.py")


def jax_config(name, opts):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "configs", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.get_config().apply_opts(opts)


def carried_weights(jcfg, tcfg, directory, seed=5):
    """Seeded, perturbed tiny flax variables of ``jcfg`` as a JAX train
    state, and a port checkpoint of the same weights under
    ``directory``."""
    variables = jax.jit(lambda key: JRDPN(jcfg, dtype=jnp.float32).init(
        key, dummy_batch(jcfg, 1), train=False))(jax.random.PRNGKey(seed))
    params, stats = perturb(variables, seed)
    pkl = os.path.join(directory, "params.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"params": params, "batch_stats": stats}, f)
    ckpt = os.path.join(directory, "ckpt")
    checkpoint_from_params_pkl(tcfg, pkl, ckpt, step=3)
    state = j_train_state(jcfg, {"params": params, "batch_stats": stats},
                          j_build_optimizer(jcfg, total_iters=1))
    return state, ckpt


def read_csv(path):
    rows = open(path).read().strip().splitlines()[1:]
    ident, R, t = [], [], []
    for r in rows:
        f = r.split(",")
        ident.append(tuple(f[:4]))
        R.append(np.array(f[4].split(), float).reshape(3, 3))
        t.append(np.array(f[5].split(), float))
    return ident, np.stack(R), np.stack(t)


def both_evals(jcfg, tcfg, split, ckpt, state, out):
    """JAX ``run_eval`` and the port's on one split in float32, their
    CSVs held to each other; returns (jax result, port result)."""
    j = j_run_eval(jcfg, ckpt_dir="", split_name=split, batch_size=4,
                   state=state, model=JRDPN(jcfg, dtype=jnp.float32),
                   csv_path=os.path.join(out, "jax.csv"))
    t = eval_runner.run_eval(tcfg, ckpt_dir=ckpt, split_name=split,
                             batch_size=4,
                             csv_path=os.path.join(out, "port.csv"),
                             dtype=torch.float32, device="cpu")
    j_id, j_R, j_t = read_csv(os.path.join(out, "jax.csv"))
    t_id, t_R, t_t = read_csv(os.path.join(out, "port.csv"))
    assert t_id == j_id and len(t_id) > 0
    np.testing.assert_allclose(t_R, j_R, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_t, j_t, rtol=1e-4, atol=0)
    assert t["per_obj"] == j["per_obj"]
    assert t["mean"] == j["mean"]
    return j, t


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
    """ycbv, tless and tudl trees under one root (2 train frames of 4
    cubes and a mostly hidden fifth, 2 PBR frames for ycbv, 2 test
    frames), and a background pool."""
    root = str(tmp_path_factory.mktemp("bop_cli"))
    for i, ds in enumerate(("ycbv", "tless", "tudl")):
        write_bop_tree(root, ds, train_frames=2, pbr_frames=2,
                       test_frames=2, seed=1 + i)
    return root, write_bg_pool(os.path.join(root, "VOC"), seed=4)


@pytest.fixture
def data_root(tree, monkeypatch):
    monkeypatch.setattr(trefs, "DATA_ROOT", tree[0])
    monkeypatch.setattr(jrefs, "DATA_ROOT", tree[0])
    return tree


def record_evals(monkeypatch):
    results = []
    run = eval_runner.run_eval

    def recording(*a, **kw):
        results.append(run(*a, **kw))
        return results[-1]

    monkeypatch.setattr(eval_runner, "run_eval", recording)
    return results


def train(config, out, pool, *extra):
    return tmain.main(["--config-file", config, "--device", "cpu", "--opts",
                       *OPTS, f'data.bg_images_dir="{pool}"',
                       "solver.total_epochs=1", "train.eval_period=2",
                       f'train.output_dir="{out}"', *extra])


def visib_fracts(root, ds, subdir):
    out = []
    for dirpath, _, files in sorted(os.walk(os.path.join(root, ds, subdir))):
        if "scene_gt_info.json" in files:
            info = json.load(open(os.path.join(dirpath,
                                               "scene_gt_info.json")))
            out += [i["visib_fract"] for v in info.values() for i in v]
    return out


def test_ycbv_records_filtered_as_jax(data_root):
    root, _ = data_root
    cfg = load_config(config_path("ycbv"), OPTS)
    jcfg = jax_config("ycbv", OPTS)
    assert cfg.data.filter_visib_thr == 0.2
    for split in ("ycbv_train_real", "ycbv_train_pbr"):
        t, j = t_records(cfg, [split]), j_records(jcfg, [split])
        assert len(t) == len(j)
        for a, b in zip(t, j):
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert np.array_equal(a[k], b[k]), k
                else:
                    assert a[k] == b[k], k
        vf = visib_fracts(root, "ycbv", split.split("_", 1)[1])
        assert len(t) == sum(v >= 0.2 for v in vf)
        assert any(0 < v < 0.2 for v in vf)     # the filter removed some


def test_cli_trains_and_scores_ycbv(data_root, tmp_path, monkeypatch):
    """ycbv's config at tiny widths, one epoch of 2 iterations with TRAIN2
    at 0.6 (RandomState(0) sends the first to ``ycbv_train_pbr``): the
    symmetric PM loss picks among the symmetric cube's 4 rotations, labels
    come from the depth surface on the PBR iteration and from the GT
    crops on the real one, and the eval on ycbv's keyframes writes the
    ADD(-S) AUC and ABSad columns, finite, and a CSV row a target."""
    from rdpn6d_tpu_torch.data import pipeline
    from rdpn6d_tpu_torch.losses import pm_loss

    root, pool = data_root
    calls = {"depth": 0, "gt": 0, "sym": []}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    closest = pm_loss.closest_rot

    def closest_spy(pred, gt, sym_rots):
        calls["sym"].append(sym_rots.detach().clone())
        return closest(pred, gt, sym_rots)

    monkeypatch.setattr(pipeline, "surface_labels",
                        spy("depth", pipeline.surface_labels))
    monkeypatch.setattr(pipeline, "gt_labels", spy("gt", pipeline.gt_labels))
    monkeypatch.setattr(pm_loss, "closest_rot", closest_spy)
    results = record_evals(monkeypatch)
    out = str(tmp_path / "ycbv")
    state = train(config_path("ycbv"), out, pool, "data.train2_ratio=0.6")
    assert state.step == 2
    assert calls["depth"] == 1 and calls["gt"] == 1
    eye = torch.eye(3)
    assert len(calls["sym"]) == 2 and any(
        bool((s - eye).abs().amax(dim=(-2, -1)).gt(0.5).any())
        for s in calls["sym"])
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert (cfg["head"]["num_classes"], cfg["loss"]["pm_loss_sym"],
            cfg["test"]["error_types"]) == (21, True,
                                            "AUCadd,AUCadi,AUCad,ad,ABSad")
    (res,) = results
    for rec in [*res["per_obj"].values(), res["mean"]]:
        for k in ("AUCadd", "AUCadi", "AUCad", "ad_2", "ad_5", "ad_10",
                  "ABSad_2cm"):
            assert np.isfinite(rec[k]), k
    targets = json.load(open(os.path.join(root, "ycbv",
                                          "test_targets_bop19.json")))
    assert {t["im_id"] for t in targets} == {0}     # the keyframes
    ident, _, _ = read_csv(os.path.join(out, "ycbv_test_bop19.csv"))
    assert len(ident) == sum(t["inst_count"] for t in targets)


def test_run_eval_ycbv_matches_jax(data_root, tmp_path):
    opts = OPTS + [f'train.output_dir="{tmp_path}"']
    jcfg = jax_config("ycbv", opts)
    tcfg = load_config(config_path("ycbv"), opts)
    state, ckpt = carried_weights(jcfg, tcfg, str(tmp_path))
    j, t = both_evals(jcfg, tcfg, "ycbv_test", ckpt, state, str(tmp_path))
    assert "bop19" not in t and "bop19" not in j
    assert {"AUCadd", "AUCadi", "ABSad_2cm"} <= set(t["mean"])


def test_cli_trains_and_scores_tless_at_540x720(data_root, tmp_path,
                                                monkeypatch):
    """tless: the frames the eval preprocesses are 540x720, the MSPD
    thresholds are scaled by 720 / 640, the BOP19 AR has AR_mssd, AR_mspd
    and their mean, and recomputing it from the written CSV and the tree
    gives the same numbers."""
    from rdpn6d_tpu_torch.data.refs import TLESS
    from rdpn6d_tpu_torch.evaluation import bop_score

    root, pool = data_root
    sizes, widths = set(), []
    from rdpn6d_tpu_torch.data import pipeline

    pre = pipeline.preprocess_rois_grouped

    def size_spy(cfg, frames, rois, *a, **kw):
        sizes.add(tuple(frames["rgb"].shape[1:3]))
        return pre(cfg, frames, rois, *a, **kw)

    ar = bop_score.bop19_average_recalls

    def ar_spy(*a, **kw):
        widths.append(kw["im_width"])
        return ar(*a, **kw)

    monkeypatch.setattr(pipeline, "preprocess_rois_grouped", size_spy)
    monkeypatch.setattr(bop_score, "bop19_average_recalls", ar_spy)
    results = record_evals(monkeypatch)
    out = str(tmp_path / "tless")
    state = train(config_path("tless"), out, pool)
    assert state.step >= 1
    assert sizes == {(540, 720)} and widths == [720]
    (res,) = results
    ar19 = res["bop19"]
    assert set(ar19) == {"AR_mssd", "AR_mspd", "AR"}
    assert ar19["AR"] == (ar19["AR_mssd"] + ar19["AR_mspd"]) / 2.0

    # the same AR from the CSV and the tree, on the host, as the smoke's
    # phase 14(b) recomputes it
    from chip_smoke import host_ar

    targets = json.load(open(os.path.join(root, "tless",
                                          "test_targets_bop19.json")))
    again = host_ar(root, out, "tless_bop_test", TLESS,
                    load_config(config_path("tless"), OPTS), targets)
    assert again == pytest.approx(ar19, abs=1e-12)


def test_cli_trains_and_scores_tudl(data_root, tmp_path, monkeypatch):
    _, pool = data_root
    results = record_evals(monkeypatch)
    out = str(tmp_path / "tudl")
    state = train(config_path("tudl"), out, pool)
    assert state.step >= 1
    (res,) = results
    assert set(res["per_obj"]) <= {"dragon", "frog", "can"}
    assert set(res["bop19"]) == {"AR_mssd", "AR_mspd", "AR"}
    assert os.path.exists(os.path.join(out, "tudl_bop_test_bop19.csv"))


def test_cli_trains_an_so_variant(data_root, tmp_path, monkeypatch):
    """``configs/so.py:ycbv/002_master_chef_can``: one object's real and
    PBR splits (TRAIN2 0.75) and its keyframe test split, one class."""
    _, pool = data_root
    results = record_evals(monkeypatch)
    out = str(tmp_path / "so")
    state = train(config_path("so") + ":ycbv/002_master_chef_can", out,
                  pool, "solver.ims_per_batch=2", "train.eval_period=1")
    assert state.step >= 1
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert (cfg["exp_name"], cfg["head"]["num_classes"],
            cfg["data"]["train2_datasets"]) == (
        "ycbvSO_002_master_chef_can", 1,
        ["ycbv_002_master_chef_can_train_pbr"])
    (res,) = results
    assert set(res["per_obj"]) == {"002_master_chef_can"}
