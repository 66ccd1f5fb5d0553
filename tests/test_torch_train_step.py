"""The port's train step against the JAX package's: 7 steps of
``make_train_step`` at the tiny configuration of the multi-chip dry run
(ResNet-18 on 64² ROIs, 16² head maps, 4 regions, 32 filters), from the
same flax init, on the same 7 seeded batches; plus the gradients of the
first step leaf by leaf, DropBlock, the BatchNorm running variance, the
frozen backbone, and the ``Trainer`` loop.

The 7-step comparison runs in float64 on both sides (``jax.enable_x64``
for the JAX package, ``.double()`` for the port). In float32 this tiny
network at init is ill-conditioned: a 1e-6 relative change of the input
moves some gradients of ``backbone.layer3.0.conv2`` by several per cent
(its float32 and float64 gradients differ as much), so float32 rounding
alone would swamp any bound. Even in float64 the JAX model rounds its logits and PnP
outputs to float32 (the port does so at the same points) and builds its
align-corners upsample weights in float32 (the port in float64): the
outputs differ by ~3e-7. The lr is 2e-5 so that the weights move a few
per cent a step: at 5e-4 the first full steps move some by ~25% and the
two trajectories part after the fourth. Tolerances: every loss within
1e-6 and ``grad_norm`` within 1e-5 relative at every step (measured: 2e-7
and 5e-6); first-step gradients within 1e-5 of each leaf's largest entry
(measured: 3e-6); after the last step every parameter and BatchNorm
statistic within 1e-2 of its leaf's total change over the run. The conv
biases that feed a batch-statistics BatchNorm get a zero gradient in exact
arithmetic; both sides' values are rounding, held to 1e-5 of the largest
gradient, and their weights are not compared.
"""

import itertools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.losses import compute_losses as j_losses
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.models.conv_pnp import dropblock as j_dropblock
from rdpn6d_tpu.parallel import create_train_state as j_create_state
from rdpn6d_tpu.parallel import make_train_step as j_make_step
from rdpn6d_tpu.solver import build_optimizer as j_build_opt
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data.synthetic import (
    dummy_grouped_inputs,
    dummy_train_batch,
)
from rdpn6d_tpu_torch.engine.trainer import Trainer
from rdpn6d_tpu_torch.models import RDPN, init_weights
from rdpn6d_tpu_torch.models.conv_pnp import dropblock
from rdpn6d_tpu_torch.models.norm import BatchNorm2d
from rdpn6d_tpu_torch.parallel import create_train_state, make_train_step
from rdpn6d_tpu_torch.parallel.train_step import _dropblock_kwargs
from rdpn6d_tpu_torch.solver import build_schedule
from rdpn6d_tpu_torch.utils.flax_params import (
    grads_from_flax,
    state_dict_from_flax,
)

STEPS = 7
B = 4
TOTAL_ITERS = 100
# __graft_entry__._dryrun_multichip_impl's tiny config, with a warmup
# short enough that 7 steps move the weights, and the MTL weights on
TINY = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16", 'head.init="fan_in"', "solver.warmup_iters=2",
        "solver.base_lr=2e-5", "loss.use_mtl=true"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _batches(cfg):
    return [dummy_train_batch(cfg, B, seed=s) for s in range(STEPS)]


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float64)
        if np.asarray(v).dtype == np.float32 else np.asarray(v), tree)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side in float64: init, first-step gradients, 7 train steps
    (two compiles: the gradient and the step)."""
    with jax.enable_x64(True):
        return _jax_run()


def _jax_run():
    cfg = JConfig().apply_opts(TINY)
    model = JRDPN(cfg, dtype=jnp.float64)
    batches = [_f64(b) for b in _batches(TConfig().apply_opts(TINY))]
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    variables = model.init(jax.random.PRNGKey(0), jb[0], train=False)
    init = _f64(jax.device_get(variables))
    variables = jax.tree_util.tree_map(jnp.asarray, init)

    def loss_fn(params, stats, batch):
        out, _ = model.apply({"params": params, "batch_stats": stats},
                             batch, train=True, mutable=["batch_stats"])
        return sum(j_losses(cfg, out, batch).values())

    grads = jax.device_get(jax.jit(jax.grad(loss_fn))(
        variables["params"], variables["batch_stats"], jb[0]))
    tx = j_build_opt(cfg, total_iters=TOTAL_ITERS)
    state = j_create_state(cfg, variables, tx)
    step = j_make_step(cfg, model, tx)
    metrics = []
    for b in jb:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"init": init, "grads": grads, "metrics": metrics,
            "params": jax.device_get(state.params),
            "stats": jax.device_get(state.batch_stats),
            "batches": batches}


@pytest.fixture(scope="module")
def torch_run(jax_run):
    cfg = TConfig().apply_opts(TINY + ["solver.amp=false"])
    model = RDPN(cfg).double()
    model.load_state_dict(state_dict_from_flax(
        cfg, jax_run["init"]["params"], jax_run["init"]["batch_stats"]))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    schedule = build_schedule(cfg, TOTAL_ITERS)
    state = create_train_state(cfg, model, lr=schedule(0))
    step = make_train_step(cfg, schedule)
    metrics, grads = [], None
    for i, b in enumerate(jax_run["batches"]):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return {"cfg": cfg, "model": model, "init": init, "metrics": metrics,
            "grads": grads, "state": state}


# conv biases right before a batch-statistics BatchNorm: zero gradient
BN_CANCELLED = ("backbone.spatial_net.xyz_emb.bias",
                "backbone.spatial_net.conv1.bias",
                "backbone.spatial_net.conv2.bias",
                "backbone.spatial_net.conv3.bias")


def test_first_step_gradients_match_jax(jax_run, torch_run):
    ref = grads_from_flax(torch_run["cfg"], jax_run["grads"])
    ours = torch_run["grads"]
    assert set(ref) == set(ours)
    top = max(float(g.abs().max()) for g in ref.values())
    for k, g in ours.items():
        scale = top if k in BN_CANCELLED else float(ref[k].abs().max())
        assert scale > 0, k
        err = float((g - ref[k].double()).abs().max())
        assert err <= 1e-5 * scale, (k, err, scale)


def test_metrics_match_jax_every_step(jax_run, torch_run):
    assert torch_run["state"].step == STEPS
    for i, (ours, ref) in enumerate(zip(torch_run["metrics"],
                                        jax_run["metrics"])):
        assert set(ours) == set(ref), i
        for k, v in ref.items():
            tol = 1e-5 if k == "grad_norm" else 1e-6
            assert abs(ours[k] - v) <= tol * max(abs(v), 1e-3), \
                (i, k, ours[k], v)


def test_params_and_batch_stats_match_jax_after_last_step(jax_run,
                                                          torch_run):
    cfg = torch_run["cfg"]
    ref = state_dict_from_flax(cfg, jax_run["params"], jax_run["stats"])
    start = torch_run["init"]
    ours = torch_run["model"].state_dict()
    moved = 0
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        v = v.double()
        change = float((v - start[k]).abs().max())
        err = float((ours[k] - v).abs().max())
        if k[:-len(".bias")] + ".bias" in BN_CANCELLED:
            continue   # moved by rounding (see the gradients' test)
        assert change > 0, k
        assert err <= 1e-2 * change, (k, err, change)
        moved += 1
    assert moved > 100


def test_dropblock_matches_jax_with_its_seeds():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 16, 16, 5).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(j_dropblock(jnp.asarray(x), key, 0.4, 5))
    gamma = 0.4 / 25
    seeds = np.asarray(jax.random.bernoulli(key, gamma, (3, 16, 16, 1)),
                       np.float32)
    ours = dropblock(torch.from_numpy(x).permute(0, 3, 1, 2), 0.4, 5,
                     seeds=torch.from_numpy(seeds).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-6, atol=1e-6)
    # the keep rate is one number over the whole batch, not per sample
    one = dropblock(torch.from_numpy(x[:1]).permute(0, 3, 1, 2), 0.4, 5,
                    seeds=torch.from_numpy(seeds[:1]).permute(0, 3, 1, 2))
    assert not torch.allclose(one, ours[:1])
    # drawn: roughly gamma of the pixels seed a block
    g = torch.Generator().manual_seed(0)
    y = dropblock(torch.ones(8, 1, 64, 64), 0.4, 5, generator=g)
    # a pixel is dropped when one of its 25 neighbours seeds: 1-(1-g)^25
    assert 0.28 < float((y == 0).float().mean()) < 0.38


def test_dropblock_ramp_and_train_mode():
    cfg = TConfig().apply_opts(["pnp.drop_prob=0.2"])
    assert _dropblock_kwargs(cfg, 0, torch.device("cpu"))["drop_scale"] \
        == 0.0
    assert _dropblock_kwargs(cfg, 2500, torch.device("cpu"))["drop_scale"] \
        == 0.5
    assert _dropblock_kwargs(cfg, 9000, torch.device("cpu"))["drop_scale"] \
        == 1.0
    assert _dropblock_kwargs(TConfig(), 10, torch.device("cpu")) == {}


def test_batchnorm_running_var_is_flaxs_biased_one():
    from flax import linen as fnn

    rng = np.random.RandomState(1)
    x = (rng.randn(3, 5, 4, 6) * 2 + 1).astype(np.float32)   # NHWC
    fb = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    v = fb.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_ref, upd = fb.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    ours = BatchNorm2d(6).train()
    y = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_ref), atol=2e-5)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(ours.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5)
    np.testing.assert_allclose(ours.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5)
    # torch's own layer moves toward the unbiased variance: visibly off
    plain = torch.nn.BatchNorm2d(6, momentum=0.1).train()
    plain(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(plain.running_var.numpy(),
                           np.asarray(stats["var"]), rtol=1e-3)


def _tiny_model(opts, seed=0):
    cfg = TConfig().apply_opts(TINY + ["solver.amp=false"] + opts)
    return cfg, init_weights(RDPN(cfg), torch.Generator().manual_seed(seed))


def test_frozen_backbone_trains_the_rest():
    cfg, model = _tiny_model(["backbone.freeze=true",
                              "solver.warmup_iters=0"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    schedule = build_schedule(cfg, TOTAL_ITERS)
    state = create_train_state(cfg, model, lr=schedule(0))
    b = dummy_train_batch(cfg, B, seed=0)
    make_train_step(cfg, schedule)(state, {k: torch.from_numpy(v)
                                           for k, v in b.items()})
    after = model.state_dict()
    for n, p in model.named_parameters():
        trunk = n.startswith("backbone.") and ".spatial_net." not in n
        assert (p.grad is None) == trunk, n
        assert torch.equal(after[n], before[n]) == trunk, n
    # the trunk's BatchNorm still tracks batch statistics, as in JAX
    assert not torch.equal(after["backbone.bn1.running_mean"],
                           before["backbone.bn1.running_mean"])


def test_trainer_on_grouped_frames(caplog):
    cfg, model = _tiny_model(["train.log_period=2"])
    frames, rois = dummy_grouped_inputs(cfg, n_frames=2, rois_per_frame=2,
                                        ship_xyz=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    seen = []
    trainer = Trainer(cfg, model, total_iters=4, device="cpu")
    with caplog.at_level(logging.INFO, logger="rdpn6d"):
        state = trainer.train(
            itertools.repeat({"frames": frames, "rois": rois}),
            step_hook=lambda it, m: seen.append(
                {k: float(v) for k, v in m.items()}))
    assert state.step == 4 and len(seen) == 4
    assert all(np.isfinite(list(m.values())).all() for m in seen)
    assert all(m["grad_norm"] > 0 for m in seen)
    assert "iter 2/4" in caplog.text and "loss_region" in caplog.text
    after = model.state_dict()
    assert not torch.equal(after["pnp_net.fc1.weight"],
                           before["pnp_net.fc1.weight"])
    assert not torch.equal(after["backbone.bn1.running_var"],
                           before["backbone.bn1.running_var"])


def test_trainer_nan_guard():
    cfg, model = _tiny_model(["train.log_period=100"])
    good = dummy_train_batch(cfg, B, seed=0)
    bad = dict(good)
    bad["roi_img"] = np.full_like(good["roi_img"], np.nan)
    trainer = Trainer(cfg, model, total_iters=5, device="cpu")
    # the NaN of iteration 1 is caught one step later, by the lag-1 guard
    with pytest.raises(FloatingPointError, match="iter 1"):
        trainer.train(iter([good, bad, good, good, good]))
    # ... and at once when it lands on the last (checkpoint) iteration
    cfg2, model2 = _tiny_model(["train.log_period=100"])
    trainer = Trainer(cfg2, model2, total_iters=2, device="cpu")
    with pytest.raises(FloatingPointError, match="checkpoint"):
        trainer.train(iter([good, bad]))
