"""The port's solver against the JAX package's: schedule value tables, the
Ranger optimizer over 13 steps against the optax chain (GC -> rectified
RAdam -> weight decay -> lr -> Lookahead, with and without a global-norm
clip) on a seeded tree of conv, transposed-conv, dense and 1-D leaves, and
the other ported optimizer names.

Leaves live in flax layouts on the JAX side and in torch layouts on the
port's (conv HWIO -> OIHW; transposed conv [kh, kw, out, in] ->
[in, out, kh, kw]; dense [in, out] -> [out, in]), and the same seeded
gradients go to both in those layouts. Tolerance: float32 updates in other
operation orders, 1e-5 of each leaf's total change over the steps (plus
1e-7 absolute); schedules to 1e-6 relative, plus 1e-6 of the base lr
where a value anneals to ~0 (float32 against float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.solver import build_optimizer as j_build_opt
from rdpn6d_tpu.solver import build_schedule as j_build_schedule
from rdpn6d_tpu.solver import flat_and_anneal as j_flat
from rdpn6d_tpu.solver import ranger as j_ranger
from rdpn6d_tpu.solver import warmup_multistep as j_multistep
from rdpn6d_tpu.solver.ranger import centralize_gradients as j_gc
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.models import RDPN
from rdpn6d_tpu_torch.solver import (
    Ranger,
    build_optimizer,
    build_schedule,
    centralize_,
    clip_by_global_norm_,
    flat_and_anneal,
    radam_step_size,
    trainable_parameters,
    warmup_multistep,
)

STEPS = 13
# flax layout -> torch layout, per leaf kind
TO_TORCH = {"conv": (3, 2, 0, 1), "conv_t": (3, 2, 0, 1), "dense": (1, 0),
            "bias": (0,), "scale": (0,)}
SHAPES = {"conv": (3, 3, 4, 8), "conv_t": (3, 3, 6, 5), "dense": (7, 5),
          "bias": (5,), "scale": (8,)}


def _tree(rng, scale=0.1):
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _to_torch(tree):
    # copies: the optimizer updates in place, the start must stay
    return {k: torch.tensor(v.transpose(TO_TORCH[k])) for k, v in
            tree.items()}


def _to_flax(k, t):
    return t.detach().numpy().transpose(np.argsort(TO_TORCH[k]))


@pytest.mark.parametrize("method", ["cosine", "linear", "poly", "exp",
                                    "none"])
def test_flat_and_anneal_table(method):
    kw = dict(warmup_iters=50, warmup_factor=0.01, anneal_point=0.6,
              anneal_method=method)
    ours = flat_and_anneal(3e-4, 400, **kw)
    ref = j_flat(3e-4, 400, **kw)
    steps = list(range(0, 420, 7)) + [49, 50, 239, 240, 241, 399, 400]
    np.testing.assert_allclose([ours(s) for s in steps],
                               [float(ref(s)) for s in steps], rtol=1e-6,
                               atol=1e-6 * 3e-4)
    with pytest.raises(ValueError):
        flat_and_anneal(1e-4, 100, anneal_point=1.5)


def test_warmup_multistep_and_build_schedule_table():
    ours = warmup_multistep(1e-3, (100, 180), warmup_iters=30)
    ref = j_multistep(1e-3, (100, 180), warmup_iters=30)
    steps = list(range(0, 220, 3)) + [99, 100, 179, 180]
    np.testing.assert_allclose([ours(s) for s in steps],
                               [float(ref(s)) for s in steps], rtol=1e-6,
                               atol=1e-6 * 1e-3)
    for sched in ("flat_and_anneal", "warmup_multistep"):
        opts = [f'solver.lr_scheduler="{sched}"', "solver.warmup_iters=20"]
        o = build_schedule(TConfig().apply_opts(opts), 90)
        r = j_build_schedule(JConfig().apply_opts(opts), 90)
        np.testing.assert_allclose([o(s) for s in range(95)],
                                   [float(r(s)) for s in range(95)],
                                   rtol=1e-6, atol=1e-6 * 1e-4)


def test_radam_plain_momentum_through_step_5():
    flags = [radam_step_size(t, 0.95, 0.999, 5.0)[1] for t in range(1, 9)]
    assert flags == [False] * 5 + [True] * 3


def test_gc_keeps_the_same_slices_as_flax():
    """GC over dims 1.. of torch layouts = flax's over all axes but the
    last, for conv, transposed conv and dense kernels; 1-D is untouched."""
    tree = _tree(np.random.RandomState(0), 1.0)
    ref, _ = j_gc().update({k: jnp.asarray(v) for k, v in tree.items()},
                           None)
    ours = _to_torch(tree)
    centralize_(list(ours.values()))
    for k in tree:
        np.testing.assert_allclose(_to_flax(k, ours[k]), np.asarray(ref[k]),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(ours["bias"].numpy(), tree["bias"])


def _run_optax(tx, params, grads_seq):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    for g in grads_seq:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, p)
        p = optax.apply_updates(p, upd)
    return {k: np.asarray(v) for k, v in p.items()}


def _run_torch(make_opt, params, grads_seq, schedule=None,
               max_grad_norm=0.0):
    tp = {k: torch.nn.Parameter(v) for k, v in _to_torch(params).items()}
    opt = make_opt(list(tp.values()))
    for i, g in enumerate(grads_seq):
        for k, v in _to_torch(g).items():
            tp[k].grad = v
        if schedule is not None:
            for group in opt.param_groups:
                group["lr"] = schedule(i)
        if max_grad_norm > 0:
            clip_by_global_norm_(tp.values(), max_grad_norm)
        opt.step()
    return {k: _to_flax(k, v) for k, v in tp.items()}


def _assert_close(ours, ref, start):
    for k in ref:
        change = float(np.abs(ref[k] - start[k]).max())
        assert change > 0, k
        err = float(np.abs(ours[k] - ref[k]).max())
        assert err <= 1e-5 * change + 1e-7, (k, err, change)


@pytest.mark.parametrize("wd,clip", [(0.0, 0.0), (0.05, 0.0), (0.0, 0.5),
                                     (0.01, 0.5)])
def test_ranger_matches_optax_chain(wd, clip):
    rng = np.random.RandomState(1)
    params = _tree(rng)
    grads = [_tree(rng, 1.0) for _ in range(STEPS)]
    for g in grads[::3]:
        g["dense"] *= 5.0            # uneven scales: the clip engages
    sched = j_flat(2e-2, 40, warmup_iters=4, anneal_point=0.2)
    tx = j_ranger(sched, weight_decay=wd)
    if clip > 0:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    ref = _run_optax(tx, params, grads)
    ours = _run_torch(lambda p: Ranger(p, weight_decay=wd), params, grads,
                      schedule=flat_and_anneal(2e-2, 40, warmup_iters=4,
                                               anneal_point=0.2),
                      max_grad_norm=clip)
    _assert_close(ours, ref, params)


def test_ranger_lookahead_syncs_every_6th_step():
    """With alpha = 0.5 at step 6 the weights land halfway between the
    slow copy (the start) and where RAdam took them."""
    p0 = torch.randn(4, 3)
    p = torch.nn.Parameter(p0.clone())
    q = torch.nn.Parameter(p0.clone())
    opt_a = Ranger([p], lr=1e-2, use_gc=False)
    opt_b = Ranger([q], lr=1e-2, use_gc=False, k=1000)   # never syncs
    for _ in range(6):
        g = torch.randn(4, 3)
        p.grad, q.grad = g.clone(), g.clone()
        opt_a.step()
        opt_b.step()
    torch.testing.assert_close(p.data, p0 + 0.5 * (q.data - p0))
    assert torch.equal(opt_a.state[p]["slow"], p.data)


@pytest.mark.parametrize("name,ref_tx", [
    ("adam", lambda s: optax.adam(s)),
    ("adamw", lambda s: optax.adamw(s, weight_decay=0.02)),
    ("sgd", lambda s: optax.sgd(s, momentum=0.9)),
])
def test_other_optimizers_match_optax(name, ref_tx):
    rng = np.random.RandomState(2)
    params = _tree(rng)
    grads = [_tree(rng, 1.0) for _ in range(6)]
    opts = [f'solver.optimizer="{name}"', "solver.weight_decay=0.02",
            "solver.warmup_iters=2", "solver.base_lr=1e-2"]
    sched = build_schedule(TConfig().apply_opts(opts), 30)
    ref = _run_optax(ref_tx(j_build_schedule(JConfig().apply_opts(opts),
                                             30)), params, grads)
    model = torch.nn.Module()
    ours = _run_torch(
        lambda p: build_optimizer(
            TConfig().apply_opts(opts),
            _holder(p, model)), params, grads, schedule=sched)
    _assert_close(ours, ref, params)


def _holder(params, module):
    for i, p in enumerate(params):
        module.register_parameter(f"p{i}", p)
    return module


def test_build_optimizer_refuses_unported_names():
    cfg = TConfig().apply_opts(['solver.optimizer="ralamb"'])
    with pytest.raises(NotImplementedError):
        build_optimizer(cfg, torch.nn.Linear(2, 2))
    # every name the JAX package builds is at least a known name there
    j_build_opt(JConfig().apply_opts(['solver.optimizer="ralamb"']), 10)


def test_freeze_leaves_only_the_trunk_out():
    opts = ["backbone.depth=18", "head.num_regions=4", "head.num_filters=32",
            "backbone.freeze=true"]
    model = RDPN(TConfig().apply_opts(opts))
    names = [n for n, _ in trainable_parameters(
        TConfig().apply_opts(opts), model)]
    assert names and not any(n.startswith("backbone.layer")
                             or n.startswith("backbone.conv1") for n in names)
    assert any(n.startswith("backbone.spatial_net.") for n in names)
    assert any(n.startswith("pnp_net.") for n in names)
    opt = build_optimizer(TConfig().apply_opts(opts), model)
    assert sum(len(g["params"]) for g in opt.param_groups) == len(names)
