"""The data and eval halves of the port's data parallelism, against the
JAX package's multi-host code and against one process.

- Rank r of 2's ``train_group_iterator`` (its sampler shard and, by
  default, ``ims_per_batch // 2`` ROIs a batch) yields byte for byte the
  JAX package's batches with ``jax.process_index`` / ``process_count``
  patched to (r, 2) and its multi-host batch size, on a synthetic LM tree
  (``data/synthetic.write_lm_tree``, 2 objects x 3 frames) and both
  samplers.
- ``shard_records_by_frame`` gives the JAX package's shards.
- ``run_eval`` on two gloo ranks of the CPU (each infers its frame shard,
  rank 0 scores the pooled predictions) gives rank 0 the one-process
  table exactly and the one-process BOP19 CSV byte for byte but for its
  time column, a wall-clock measurement; rank 1 returns only its stats.
  Float32, the tiny configuration, seeded and perturbed flax weights as in
  ``test_torch_eval_runner.py``.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rdpn6d_tpu.data.refs as jrefs
import rdpn6d_tpu_torch.data.refs as trefs
import torch_dist_workers as workers
from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.data import bop as jbop
from rdpn6d_tpu.data import loader as jloader
from rdpn6d_tpu.engine.eval_runner import \
    shard_records_by_frame as j_shard
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.models import dummy_batch
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data import bop as tbop
from rdpn6d_tpu_torch.data import loader as tloader
from rdpn6d_tpu_torch.data.synthetic import write_lm_tree
from rdpn6d_tpu_torch.engine.eval_runner import \
    shard_records_by_frame as t_shard
from rdpn6d_tpu_torch.parallel import spawn
from rdpn6d_tpu_torch.utils.flax_params import checkpoint_from_params_pkl
from tests.test_torch_model import TINY, perturb
from tests.test_torch_train_data import assert_same

OBJS = {"ape": 1, "can": 5}
OPTS = TINY + ["backbone.rot_concat=true", "loss.num_pm_points=500",
               "solver.ims_per_batch=4"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tree, with its train and test lists registered in both
    packages."""
    root = str(tmp_path_factory.mktemp("dist_tree"))
    write_lm_tree(root, OBJS, frames_per_obj=3, seed=4)
    for mod in (jbop, tbop):
        mod.register_split(mod.Split(
            "dist_lm_train", "lm", "test", objs=tuple(OBJS),
            per_obj_index="image_set/{obj}_train.txt"))
        mod.register_split(mod.Split(
            "dist_lm_test", "lm", "test", objs=tuple(OBJS),
            filter_invalid=False,
            per_obj_index="image_set/{obj}_test.txt"))
    return root


@pytest.fixture
def data_root(tree, monkeypatch):
    monkeypatch.setattr(jrefs, "DATA_ROOT", tree)
    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    return tree


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("repeat", [0.0, 0.5])
def test_rank_batches_match_jax_multihost(data_root, monkeypatch, rank,
                                          repeat):
    opts = OPTS + [f"data.repeat_factor_thresh={repeat}"]
    tcfg, jcfg = TConfig().apply_opts(opts), JConfig().apply_opts(opts)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    t_it = tloader.train_group_iterator(
        tcfg, "dist_lm_train", seed=3, num_workers=2, frame_bucket=2,
        shard_id=rank, num_shards=2)
    j_it = jloader.train_group_iterator(
        jcfg, "dist_lm_train", seed=3, num_workers=2, frame_bucket=2,
        batch_size=2)
    for i in range(4):
        tb = next(t_it)
        assert_same(tb, next(j_it), f"rank {rank} batch {i}")
        assert tb["rois"]["frame_idx"].shape == (2,)
    t_it.close()
    j_it.close()


def test_shard_records_by_frame_matches_jax():
    rng = np.random.RandomState(0)
    recs = [{"scene_id": int(s), "im_id": int(i), "obj_id": k}
            for k, (s, i) in enumerate(zip(rng.randint(1, 4, 40),
                                           rng.randint(0, 9, 40)))]
    for n in (1, 2, 3):
        shards = [t_shard(recs, r, n) for r in range(n)]
        assert shards == [j_shard(recs, r, n) for r in range(n)]
        assert sorted(x["obj_id"] for s in shards for x in s) == \
            list(range(40))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = JConfig().apply_opts(OPTS)
    variables = jax.jit(lambda key: JRDPN(cfg, dtype=jnp.float32).init(
        key, dummy_batch(cfg, 1), train=False))(jax.random.PRNGKey(5))
    params, stats = perturb(variables, 5)
    d = tmp_path_factory.mktemp("dist_weights")
    with open(d / "params.pkl", "wb") as f:
        pickle.dump({"params": params, "batch_stats": stats}, f)
    checkpoint_from_params_pkl(TConfig().apply_opts(OPTS),
                               str(d / "params.pkl"), str(d / "ckpt"),
                               step=7)
    return str(d / "ckpt")


def _without_time(path):
    with open(path) as f:
        return [line.rsplit(",", 1)[0] for line in f]


def test_two_rank_eval_gives_rank0_the_one_process_result(tree, ckpt,
                                                          tmp_path):
    split = tbop.get_split("dist_lm_test")
    one_csv, two_csv = str(tmp_path / "one.csv"), str(tmp_path / "two.csv")
    one = workers.run_eval("cpu", OPTS, tree, split, ckpt, one_csv)
    r0, r1 = spawn(workers.run_eval, 2, device="cpu",
                   args=(OPTS, tree, split, ckpt, two_csv))
    assert r0["per_obj"] == one["per_obj"] and r0["mean"] == one["mean"]
    assert set(one["per_obj"]) == set(OBJS)
    assert set(r1) == {"stats"}
    assert r0["stats"]["n_rois"] + r1["stats"]["n_rois"] \
        == one["stats"]["n_rois"] == 6
    assert _without_time(two_csv) == _without_time(one_csv)
    assert len(_without_time(one_csv)) == 7
