"""``solver.remat`` and ``data.fused_train_step`` in the port.

Remat (``models/rdpn.py``: the trunk and the dense head under
``torch.utils.checkpoint`` in train mode, BatchNorm moving its running
statistics once, ``models/norm.recomputing``):

* against the JAX package's ``RDPN`` with ``solver.remat`` (flax's
  ``nn.remat``) in train mode on the same seeded batch and perturbed
  flax init: ``rot_ego``, ``trans`` and the moved running statistics
  within 1e-6 of their largest magnitude, in float64 on both sides as
  ``test_torch_train_step.py`` runs the train mode (in float32 this tiny
  network's batch-statistics forward parts by ~1e-4 on rounding alone;
  JAX still rounds its logits and PnP outputs to float32);
* against the port without remat, one ``make_train_step`` step in float32
  (and one under bf16 autocast, which the recompute must re-enter): the
  forward bit-equal, every loss, ``grad_norm``, gradient and parameter
  within 1e-6 relative of the largest (measured: equal), every running
  statistic and ``num_batches_tracked`` bit-equal (a second update in the
  recompute would move them), the same ``state_dict`` keys, and the trunk's
  BatchNorm run again in the backward pass; with ``rot_concat`` (the
  trunk's tuple output), the s2d stem and ``backbone.freeze`` (no trunk
  gradient).

The fused step (``parallel.make_fused_train_step``):

* against the JAX package's ``make_fused_sharded_train_step`` on a
  one-device mesh, on the same raw grouped batch and flax init, the DZI
  boxes JAX drew injected (``center_scale``), colour aug off, float32:
  the first step's losses within 1e-4 relative (the crop's taps differ by
  an FMA, ``test_torch_train_labels``, and a region id near a tie may
  flip) and ``grad_norm`` within 1e-2 (measured 1.4e-3: in float32 this
  tiny network's gradients at init move by per cents under a 1e-6
  change of the input, ``test_torch_train_step.py``);
* against the two calls ``Trainer`` makes with the flag on and off (the
  flag changes nothing in eager PyTorch), 2 steps: metrics and the state
  bit-equal;
* one process only.

Two gloo ranks with remat are in ``test_torch_dist_step.py``.
"""

import itertools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.data.pipeline import preprocess_rois_grouped as j_grouped
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.models import dummy_batch as j_dummy_batch
from rdpn6d_tpu.parallel import create_mesh
from rdpn6d_tpu.parallel import create_train_state as j_create_state
from rdpn6d_tpu.parallel import make_fused_sharded_train_step as j_fused
from rdpn6d_tpu.parallel import replicate
from rdpn6d_tpu.solver import build_optimizer as j_build_opt
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data.synthetic import (
    dummy_grouped_inputs,
    dummy_train_batch,
)
from rdpn6d_tpu_torch.engine.trainer import Trainer
from rdpn6d_tpu_torch.models import RDPN, init_weights
from rdpn6d_tpu_torch.models.norm import BatchNorm2d
from rdpn6d_tpu_torch.parallel import (
    create_train_state,
    make_fused_train_step,
    make_train_step,
    train_step,
)
from rdpn6d_tpu_torch.solver import build_schedule
from rdpn6d_tpu_torch.utils.flax_params import state_dict_from_flax
from tests.test_torch_model import make_batch, perturb

TINY = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16", 'head.init="fan_in"', "solver.warmup_iters=0"]
B = 4
STEP_TOL = 1e-6
X64_TOL = 1e-6
LOSS_TOL = 1e-4          # the fused step against JAX's, float32
GRAD_NORM_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# -- remat against the JAX package -------------------------------------------

@pytest.fixture(scope="module")
def flax_init():
    """The flax init of ``TINY`` + rot_concat in float64 (one compile),
    perturbed; its tree is the same with or without remat."""
    cfg = JConfig().apply_opts(TINY + ["backbone.rot_concat=true"])
    with jax.enable_x64(True):
        model = JRDPN(cfg, dtype=jnp.float64)
        variables = jax.jit(lambda k, b: model.init(k, b, train=False))(
            jax.random.PRNGKey(0), j_dummy_batch(cfg, 1))
        return tuple(jax.tree_util.tree_map(
            lambda v: np.asarray(v, np.float64), t)
            for t in perturb(variables, 1))


def test_remat_train_forward_matches_jax(flax_init):
    opts = TINY + ["solver.remat=true", "backbone.rot_concat=true"]
    cfg_j = JConfig().apply_opts(opts)
    params, stats = flax_init
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in make_batch(cfg_j, B, seed=5).items()}
    with jax.enable_x64(True):
        model = JRDPN(cfg_j, dtype=jnp.float64)
        ref, moved = jax.jit(lambda v, b: model.apply(
            v, b, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats},
            {k: jnp.asarray(v) for k, v in batch.items()})
        ref = {k: np.asarray(ref[k]) for k in ("rot_ego", "trans")}
        moved = jax.device_get(moved["batch_stats"])
    cfg = TConfig().apply_opts(opts)
    tm = RDPN(cfg).double()
    tm.load_state_dict(state_dict_from_flax(cfg, params, stats))
    tm.train()
    out = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    for k, want in ref.items():
        err = float(np.abs(out[k].detach().numpy() - want).max())
        assert err <= X64_TOL * float(np.abs(want).max()), (k, err)
    want = state_dict_from_flax(cfg, params, moved)
    got = tm.state_dict()
    n = 0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            err = float((got[k] - v).abs().max())
            assert err <= X64_TOL * float(v.abs().max()), (k, err)
            n += 1
    assert n > 40


# -- remat against no remat --------------------------------------------

REMAT_CASES = {
    "plain": [],
    "rot_concat": ["backbone.rot_concat=true"],
    "s2d": ["backbone.space_to_depth=true"],
    "freeze": ["backbone.freeze=true"],
    "bf16_autocast": ["solver.amp=true", "backbone.rot_concat=true"],
}


def _one_step(opts, remat: bool):
    """One ``make_train_step`` step from the seeded init: (forward outputs
    before the step, metrics, gradients, state_dict, trunk BN calls)."""
    cfg = TConfig().apply_opts(TINY + ["solver.amp=false"] + opts + [
        f"solver.remat={str(remat).lower()}"])
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v)
             for k, v in dummy_train_batch(cfg, B, seed=3).items()}
    calls = []
    bn = model.backbone.bn1
    assert isinstance(bn, BatchNorm2d)
    handle = bn.register_forward_hook(lambda *a: calls.append(1))
    with torch.no_grad():
        probe = {k: v.clone() for k, v in model.eval()(batch).items()}
    schedule = build_schedule(cfg, 100)
    state = create_train_state(cfg, model, lr=schedule(0))
    state, metrics = make_train_step(cfg, schedule)(state, batch)
    handle.remove()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return (probe, {k: float(v) for k, v in metrics.items()}, grads,
            {k: v.clone() for k, v in model.state_dict().items()},
            len(calls), model)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_remat_equals_no_remat(case):
    p0, m0, g0, s0, calls0, _ = _one_step(REMAT_CASES[case], False)
    p1, m1, g1, s1, calls1, model = _one_step(REMAT_CASES[case], True)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    assert set(m0) == set(m1)
    for k, v in m0.items():
        assert abs(m1[k] - v) <= STEP_TOL * max(abs(v), 1e-3), (k, m1[k], v)
    assert set(g0) == set(g1)
    for k in g0:
        assert _rel(g1[k], g0[k]) <= STEP_TOL, k
    assert list(s0) == list(s1)       # the same keys, in the same order
    stats = 0
    for k, v in s0.items():
        if k.endswith(("running_mean", "running_var",
                       "num_batches_tracked")):
            assert torch.equal(s1[k], v), k
            stats += 1
        else:
            assert _rel(s1[k], v) <= STEP_TOL, k
    assert stats > 60
    assert int(s1["backbone.bn1.num_batches_tracked"]) == 1
    if case == "freeze":
        # the trunk's output is detached: no gradient, no recompute
        assert not any(n.startswith("backbone.layer") for n in g1)
        assert calls1 == calls0
    else:
        # the trunk ran again in the backward pass
        assert calls1 == calls0 + 1
    assert model.training


def test_remat_eval_mode_is_the_plain_forward():
    cfg = TConfig().apply_opts(TINY + ["solver.remat=true"])
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(0)).eval()
    batch = {k: torch.from_numpy(v)
             for k, v in dummy_train_batch(cfg, 2, seed=1).items()}
    calls = []
    model.backbone.bn1.register_forward_hook(lambda *a: calls.append(1))
    out = model(batch)
    out["trans"].sum().backward()
    assert len(calls) == 1            # nothing recomputed in eval mode
    with torch.no_grad():
        ref = model(batch)
    assert torch.equal(out["trans"].detach(), ref["trans"])


# -- the fused step -----------------------------------------------------

FUSED = TINY + ["solver.amp=false", "data.color_aug_prob=0",
               "backbone.rot_concat=true"]


def _raw(cfg, seed=7):
    return dummy_grouped_inputs(cfg, n_frames=2, rois_per_frame=2,
                                seed=seed, ship_xyz=True)


def test_fused_step_matches_jax_fused_step(flax_init):
    cfg_j = JConfig().apply_opts(FUSED)
    frames, rois = _raw(TConfig().apply_opts(FUSED))
    fj = {k: jnp.asarray(v) for k, v in frames.items()}
    rj = {k: jnp.asarray(v) for k, v in rois.items()}
    key = jax.random.PRNGKey(11)
    pre = j_grouped(cfg_j, fj, rj, key, train=True)
    params, stats = (jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32), t) for t in flax_init)
    model = JRDPN(cfg_j, dtype=jnp.float32)
    tx = j_build_opt(cfg_j, total_iters=100)
    m = create_mesh(1)
    state = replicate(j_create_state(
        cfg_j, {"params": params, "batch_stats": stats}, tx), m)
    _, ref = j_fused(cfg_j, model, tx, m)(state, fj, rj, key)
    ref = {k: float(v) for k, v in ref.items()}

    cfg = TConfig().apply_opts(FUSED)
    tm = RDPN(cfg)
    tm.load_state_dict(state_dict_from_flax(cfg, params, stats))
    schedule = build_schedule(cfg, 100)
    tstate = create_train_state(cfg, tm, lr=schedule(0))
    _, got = make_fused_train_step(cfg, schedule)(
        tstate, {k: torch.from_numpy(v) for k, v in frames.items()},
        {k: torch.from_numpy(v) for k, v in rois.items()},
        center_scale=(torch.tensor(np.asarray(pre["bbox_center"])),
                      torch.tensor(np.asarray(pre["scale"]))))
    got = {k: float(v) for k, v in got.items()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        tol = GRAD_NORM_TOL if k == "grad_norm" else LOSS_TOL
        assert abs(got[k] - v) <= tol * max(abs(v), 1e-3), (k, got[k], v)


def _trainer_run(tmp_path, fused: bool):
    cfg = TConfig().apply_opts(FUSED + [
        f"data.fused_train_step={str(fused).lower()}",
        "train.log_period=100", "train.checkpoint_period_epochs=1e9",
        f'train.output_dir="{tmp_path / str(fused)}"'])
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(0))
    frames, rois = _raw(cfg)
    trainer = Trainer(cfg, model, total_iters=2, device="cpu")
    seen = []
    state = trainer.train(
        itertools.repeat({"frames": frames, "rois": rois}),
        step_hook=lambda it, m: seen.append(
            {k: v.clone() for k, v in m.items()}))
    shutil.rmtree(tmp_path / str(fused))
    return seen, state.model.state_dict()


def _fused_run():
    """2 steps of ``make_fused_train_step`` from the trainer's weights,
    schedule and DZI generator."""
    cfg = TConfig().apply_opts(FUSED)
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(0))
    frames, rois = _raw(cfg)
    frames = {k: torch.from_numpy(v) for k, v in frames.items()}
    rois = {k: torch.from_numpy(v) for k, v in rois.items()}
    schedule = build_schedule(cfg, 2)
    state = create_train_state(cfg, model, lr=schedule(0))
    fused = make_fused_train_step(cfg, schedule)
    generator = torch.Generator().manual_seed(cfg.train.seed)
    seen = []
    for _ in range(2):
        state, m = fused(state, frames, rois, generator)
        seen.append({k: v.clone() for k, v in m.items()})
    return seen, state.model.state_dict()


def test_fused_step_equals_two_calls_through_trainer(tmp_path):
    """``Trainer``'s two calls, with ``data.fused_train_step`` off and on,
    and ``make_fused_train_step``: the same metrics and state bit for bit
    after 2 steps."""
    m0, s0 = _fused_run()
    for fused in (False, True):
        m1, s1 = _trainer_run(tmp_path, fused)
        assert len(m0) == len(m1) == 2
        for a, b in zip(m0, m1):
            assert set(a) == set(b)
            for k in a:
                assert torch.equal(a[k], b[k]), (fused, k)
        assert list(s0) == list(s1)
        for k in s0:
            assert torch.equal(s0[k], s1[k]), (fused, k)


def test_fused_step_is_one_process_only(monkeypatch):
    cfg = TConfig().apply_opts(FUSED + ["data.fused_train_step=true"])
    monkeypatch.setattr(train_step, "world", lambda: 2)
    with pytest.raises(RuntimeError, match="one process"):
        make_fused_train_step(cfg, lambda it: 0.0)
