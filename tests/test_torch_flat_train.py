"""The flat per-instance train path (``data.grouped_train=false``) against
the JAX package's, on an lm + lm_imgn tree on disk:

- ``train_frame_iterator``'s first batches (full-frame float32 samples of
  ``RecordDecoder.__call__``, background replacement and truncation on),
  equal byte for byte at 1 and 3 decode threads, with and without the
  repeat-factor sampler, and a rank's shard of a 2-process stream;
- ``pipeline.preprocess_batch`` on such a batch, with the DZI box off and
  with the JAX package's DZI boxes injected;
- one train step on it: preprocessing, forward and the losses, from the
  same flax init, and the labels' one ``gt_labels`` call on the float32
  planes. ``test_torch_cli_flat.py`` drives the path through ``main``.

Tolerances, as ``test_torch_train_labels.py`` sets them: batches equal
byte for byte; the bilinear crops' colour and 2-D coordinate channels
within 5e-5 (XLA contracts a tap's source coordinate into an FMA, so a
tap may sit an ulp, <= 6.1e-5 px below 512, away), their depth-derived
channels (the back-projected xyz) within 1e-3: at the injected DZI boxes'
scales of up to ~400 px, resize_ratio is ~0.04 and depth / resize_ratio
jumps by up to ~15 across a cube's silhouette, 9e-4 over an ulp of the
tap (measured: 4.9e-4); the masks equal, region ids equal on >= 0.999
of the pixels and the coordinates within 1e-5 where they are; the pose
targets within 1e-6. The step's losses within 1e-4 relative (float32
through the tiny network on inputs that differ by the crops').
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rdpn6d_tpu.data.refs as jrefs
import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.data import bop as jbop
from rdpn6d_tpu.data import loader as jloader
from rdpn6d_tpu.data.pipeline import preprocess_batch as j_preprocess
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.models import dummy_batch
from rdpn6d_tpu.losses import compute_losses as j_losses
from rdpn6d_tpu.parallel.train_step import \
    _dropblock_kwargs as j_dropblock_kwargs
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data import bop as tbop
from rdpn6d_tpu_torch.data import loader as tloader
from rdpn6d_tpu_torch.data import pipeline
from rdpn6d_tpu_torch.data.synthetic import (
    write_bg_pool,
    write_lm_imgn_tree,
    write_lm_tree,
)
from rdpn6d_tpu_torch.models import RDPN
from rdpn6d_tpu_torch.parallel import create_train_state, make_train_step
from rdpn6d_tpu_torch.solver import build_schedule
from rdpn6d_tpu_torch.utils.flax_params import state_dict_from_flax
from tests.test_torch_train_data import assert_same

OBJS = {"ape": 1, "can": 5}
SPLITS = ["flat_lm_train", "flat_imgn_train"]
TINY = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16", 'head.init="fan_in"', "loss.num_pm_points=500",
        "solver.ims_per_batch=4", "data.truncate_fg=true"]
CROP_TOL = 5e-5
DEPTH_TOL = 1e-3
COORD_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """2 objects x 3 frames in each layout, a background pool, and the
    train splits registered in both packages."""
    root = str(tmp_path_factory.mktemp("flat_tree"))
    write_lm_tree(root, OBJS, frames_per_obj=3, seed=4)
    write_lm_imgn_tree(root, OBJS, frames_per_obj=3, seed=5)
    pool = write_bg_pool(os.path.join(root, "VOC"), seed=6)
    for mod in (jbop, tbop):
        mod.register_split(mod.Split(
            "flat_lm_train", "lm", "test", objs=tuple(OBJS),
            per_obj_index="image_set/{obj}_train.txt"))
        mod.register_split(mod.Split(
            "flat_imgn_train", "lm_imgn", "imgn", objs=tuple(OBJS),
            per_obj_index="image_set/train_{obj}.txt"))
    return root, pool


@pytest.fixture
def data_root(tree, monkeypatch):
    monkeypatch.setattr(jrefs, "DATA_ROOT", tree[0])
    monkeypatch.setattr(trefs, "DATA_ROOT", tree[0])
    return tree


def opts(pool, *extra):
    return TINY + ["data.change_bg_prob=0.5",
                   f'data.bg_images_dir="{pool}"', *extra]


def first_batches(cfg_opts, n, workers, seed=3, **kw):
    t_it = tloader.train_frame_iterator(TConfig().apply_opts(cfg_opts),
                                        SPLITS, seed=seed,
                                        num_workers=workers, **kw)
    j_it = jloader.train_frame_iterator(JConfig().apply_opts(cfg_opts),
                                        SPLITS, seed=seed,
                                        num_workers=workers)
    out = [(next(t_it), next(j_it)) for _ in range(n)]
    t_it.close()
    return out


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("repeat", [0.0, 0.5])
def test_train_frame_iterator_matches_jax(data_root, workers, repeat):
    """The first 3 batches byte for byte; each holds 4 samples of full
    float32 frames, and background replacement cut some foregrounds."""
    _, pool = data_root
    pairs = first_batches(
        opts(pool, f"data.repeat_factor_thresh={repeat}"), 3, workers)
    cut = 0
    for i, (tb, jb) in enumerate(pairs):
        assert_same(tb, jb, f"batch {i}")
        assert tb["rgb"].shape == (4, 480, 640, 3)
        assert tb["rgb"].dtype == tb["xyz"].dtype == np.float32
        cut += int((tb["mask_trunc"] != tb["mask_visib"]).any())
    assert cut > 0


def test_train_frame_iterator_shard_matches_jax(data_root, monkeypatch):
    """Rank 1 of 2 streams the JAX package's second process's batches
    (``jax.process_index`` patched), 2 ROIs a batch by default."""
    _, pool = data_root
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    cfg = opts(pool)
    t_it = tloader.train_frame_iterator(TConfig().apply_opts(cfg), SPLITS,
                                        seed=2, num_workers=2, shard_id=1,
                                        num_shards=2)
    j_it = jloader.train_frame_iterator(JConfig().apply_opts(cfg), SPLITS,
                                        seed=2, num_workers=2, batch_size=2)
    for i in range(2):
        tb = next(t_it)
        assert tb["rgb"].shape[0] == 2
        assert_same(tb, next(j_it), f"batch {i}")
    t_it.close()


def jax_batch(cfg_opts, samples, seed=0):
    return jax.device_get(j_preprocess(
        JConfig().apply_opts(cfg_opts),
        {k: jnp.asarray(v) for k, v in samples.items()},
        jax.random.PRNGKey(seed), train=True))


def torch_batch(cfg_opts, samples, center_scale=None):
    return pipeline.preprocess_batch(
        TConfig().apply_opts(cfg_opts),
        {k: torch.from_numpy(v) for k, v in samples.items()}, train=True,
        center_scale=center_scale)


def assert_labels_close(t, j):
    assert set(t) == set(j)
    for k, depth in (("roi_img", slice(3, 6)), ("roi_coord_2d", slice(0, 3))):
        other = np.ones(j[k].shape[-1], bool)
        other[depth] = False
        np.testing.assert_allclose(t[k].numpy()[..., other], j[k][..., other],
                                   rtol=0, atol=CROP_TOL, err_msg=k)
        np.testing.assert_allclose(t[k].numpy()[..., depth], j[k][..., depth],
                                   rtol=0, atol=DEPTH_TOL, err_msg=k)
    for k in ("roi_mask_visib", "roi_mask_obj", "roi_mask_trunc"):
        np.testing.assert_array_equal(t[k].numpy(), j[k], err_msg=k)
    same = t["roi_region"].numpy() == j["roi_region"]
    assert same.mean() >= 0.999
    np.testing.assert_allclose(t["roi_xyz"].numpy()[same], j["roi_xyz"][same],
                               rtol=0, atol=COORD_TOL)
    for k in ("bbox_center", "scale", "roi_wh", "resize_ratio", "roi_cam",
              "trans_ratio", "gt_allo_rot6d", "gt_rot", "gt_trans", "fps",
              "roi_extent", "roi_points", "sym_rots"):
        np.testing.assert_allclose(t[k].numpy(), j[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(t["roi_cls"].numpy(), j["roi_cls"])


@pytest.mark.parametrize("dzi", ["none", "injected"])
def test_preprocess_batch_matches_jax(data_root, dzi):
    _, pool = data_root
    cfg = opts(pool, 'data.dzi_type="none"') if dzi == "none" \
        else opts(pool)
    # a batch where background replacement cut a foreground
    samples = next(t for t, _ in first_batches(cfg, 3, 1)
                   if (t["mask_trunc"] != t["mask_visib"]).any())
    j = jax_batch(cfg, samples)
    cs = None if dzi == "none" else (torch.tensor(j["bbox_center"]),
                                     torch.tensor(j["scale"]))
    t = torch_batch(cfg, samples, cs)
    assert t["roi_mask_trunc"].shape == (4, 16, 16)
    assert_labels_close(t, j)
    # the truncated foreground reaches the labels: trunc is not visib
    assert not torch.equal(t["roi_mask_trunc"], t["roi_mask_visib"])


def test_preprocess_batch_feeds_gt_labels_the_float32_planes(
        data_root, monkeypatch):
    """One ``roi_crop`` and one ``gt_labels`` call a batch, the labels fed
    the separate float32 visib and trunc planes and float32 xyz."""
    _, pool = data_root
    seen = []
    labels, crop = pipeline.gt_labels, pipeline.roi_crop

    def spy_labels(mask, trunc, xyz, *a, **kw):
        seen.append(("gt_labels", mask.dtype, trunc.dtype, xyz.dtype,
                     tuple(xyz.shape)))
        return labels(mask, trunc, xyz, *a, **kw)

    def spy_crop(*a, **kw):
        seen.append(("roi_crop",))
        return crop(*a, **kw)

    monkeypatch.setattr(pipeline, "gt_labels", spy_labels)
    monkeypatch.setattr(pipeline, "roi_crop", spy_crop)
    (samples, _), = first_batches(opts(pool), 1, 1)
    torch_batch(opts(pool), samples)
    assert seen == [("roi_crop",), ("gt_labels", torch.float32,
                                    torch.float32, torch.float32,
                                    (4, 480, 640, 3))]


def test_flat_train_step_losses_match_jax(data_root):
    """The first step of each package from the same flax init on the same
    flat batch (the JAX DZI boxes injected): every loss of the step, the
    JAX side's as its step's body computes them (train-mode forward at
    step 0, then ``compute_losses``)."""
    _, pool = data_root
    cfg_opts = opts(pool, "solver.amp=false")
    (samples, _), = first_batches(cfg_opts, 1, 1)
    jcfg = JConfig().apply_opts(cfg_opts)
    jb = {k: jnp.asarray(v) for k, v in jax_batch(cfg_opts, samples).items()}
    model = JRDPN(jcfg, dtype=jnp.float32)
    variables = jax.device_get(jax.jit(lambda key: model.init(
        key, dummy_batch(jcfg, 1), train=False))(jax.random.PRNGKey(0)))

    @jax.jit
    def j_step_losses(variables, batch):
        out, _ = model.apply(variables, batch, train=True,
                             mutable=["batch_stats"],
                             **j_dropblock_kwargs(jcfg, jnp.int32(0)))
        losses = j_losses(jcfg, out, batch)
        return {**losses, "total_loss": sum(losses.values())}

    j_metrics = jax.device_get(j_step_losses(variables, jb))

    tcfg = TConfig().apply_opts(cfg_opts)
    tmodel = RDPN(tcfg)
    tmodel.load_state_dict(state_dict_from_flax(
        tcfg, variables["params"], variables["batch_stats"]))
    tb = torch_batch(cfg_opts, samples,
                     (torch.tensor(np.asarray(jb["bbox_center"])),
                      torch.tensor(np.asarray(jb["scale"]))))
    schedule = build_schedule(tcfg, 10)
    _, t_metrics = make_train_step(tcfg, schedule)(
        create_train_state(tcfg, tmodel, lr=schedule(0)), tb)
    losses = [k for k in j_metrics if k.startswith("loss_")]
    assert len(losses) >= 4 and set(losses) <= set(t_metrics)
    for k in losses + ["total_loss"]:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]),
                                   rtol=1e-4, err_msg=k)
