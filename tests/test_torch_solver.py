"""The port's solver against the JAX package's: schedule value tables, the
Ranger optimizer over 13 steps against the optax chain (GC -> rectified
RAdam -> weight decay -> lr -> Lookahead, with and without a global-norm
clip) on a seeded tree of conv, transposed-conv, dense and 1-D leaves, and
every other optimizer name ``build_optimizer`` knows: each over 13 steps
against ``rdpn6d_tpu.solver.build_optimizer`` under both ``solver.host_lr``
values (weight decay and the clip on), and with ``backbone.freeze``. The
lr each update applies is the schedule at ``schedule_step`` (the JAX
package's ralamb, rangerlars, adamp and sgdp read it one step later unless
``host_lr`` injects it); with ``host_lr`` the JAX side gets the
schedule's float32 table written into its injected hyperparameter, as its
trainer does.

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
    schedule_step,
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


NEW_NAMES = ["ranger_adabelief", "adamp", "sgdp", "ralamb", "rangerlars",
             "rmsprop_tf", "sgd_gcc", "radam", "adabelief", "lookahead_adam",
             "sgd_gc"]


def _named_holder(tp, frozen=()):
    """A module whose parameter names are the tree's keys; ``frozen`` ones
    sit under ``backbone.`` (the trunk ``backbone.freeze`` leaves out)."""
    module = torch.nn.Module()
    module.backbone = torch.nn.Module()
    for k, p in tp.items():
        (module.backbone if k in frozen else module).register_parameter(k, p)
    return module


def _run_name(name, host_lr, freeze, params, grads):
    opts = [f'solver.optimizer="{name}"', "solver.weight_decay=0.01",
            "solver.warmup_iters=4", "solver.base_lr=2e-2",
            "solver.anneal_point=0.2", "solver.max_grad_norm=0.5",
            f"solver.host_lr={str(host_lr).lower()}",
            f"backbone.freeze={str(freeze).lower()}"]
    jcfg, tcfg = JConfig().apply_opts(opts), TConfig().apply_opts(opts)
    total = 40
    # JAX: the masked chain over a flat tree, "backbone" the frozen leaf
    tx = j_build_opt(jcfg, total)
    table = np.asarray(jax.vmap(j_build_schedule(jcfg, total))(
        jnp.arange(total, dtype=jnp.float32)))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    for i, g in enumerate(grads):
        if host_lr:
            state = state._replace(hyperparams={
                **state.hyperparams, "learning_rate": np.float32(table[i])})
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, p)
        p = optax.apply_updates(p, upd)
    ref = {k: np.asarray(v) for k, v in p.items()}
    # the port, as its train step drives the optimizer
    tp = {k: torch.nn.Parameter(v) for k, v in _to_torch(params).items()}
    opt = build_optimizer(tcfg, _named_holder(tp, ("backbone",) if freeze
                                              else ()))
    schedule = build_schedule(tcfg, total)
    for i, g in enumerate(grads):
        for k, v in _to_torch(g).items():
            tp[k].grad = v
        for group in opt.param_groups:
            group["lr"] = schedule(schedule_step(tcfg, i))
        clip_by_global_norm_([q for gr in opt.param_groups
                              for q in gr["params"]], 0.5)
        opt.step()
    return {k: _to_flax(k, v) for k, v in tp.items()}, ref


@pytest.mark.parametrize("host_lr", [False, True])
@pytest.mark.parametrize("name", NEW_NAMES)
def test_every_name_matches_jax(name, host_lr):
    rng = np.random.RandomState(3)
    params = _tree(rng)
    grads = [_tree(rng, 1.0) for _ in range(STEPS)]
    for g in grads[::3]:
        g["dense"] *= 5.0            # uneven scales: the clip engages
    ours, ref = _run_name(name, host_lr, False, params, grads)
    _assert_close(ours, ref, params)


@pytest.mark.parametrize("name", NEW_NAMES)
def test_every_name_with_frozen_backbone(name):
    """backbone.freeze: the trunk's leaf (a conv, zero gradient as the
    model's stop-gradient gives it) stays put on both sides, weight decay
    included; the rest matches."""
    rng = np.random.RandomState(4)
    params = _tree(rng)
    params["backbone"] = params["conv"][::-1].copy()
    grads = [_tree(rng, 1.0) for _ in range(STEPS)]
    for g in grads:
        g["backbone"] = np.zeros_like(params["backbone"])
    TO_TORCH["backbone"] = TO_TORCH["conv"]
    try:
        ours, ref = _run_name(name, False, True, params, grads)
    finally:
        del TO_TORCH["backbone"]
    np.testing.assert_array_equal(ours.pop("backbone"), params["backbone"])
    np.testing.assert_array_equal(ref.pop("backbone"), params["backbone"])
    _assert_close(ours, ref, params)


def test_unknown_name_raises_value_error_on_both_sides():
    opts = ['solver.optimizer="adamax"']
    with pytest.raises(ValueError):
        build_optimizer(TConfig().apply_opts(opts), torch.nn.Linear(2, 2))
    with pytest.raises(ValueError):
        j_build_opt(JConfig().apply_opts(opts), 10)


def test_schedule_step_reads_one_later_where_jax_does():
    for name in NEW_NAMES + ["ranger", "adam", "adamw", "sgd"]:
        for host_lr in (False, True):
            cfg = TConfig().apply_opts([
                f'solver.optimizer="{name}"',
                f"solver.host_lr={str(host_lr).lower()}"])
            late = name in ("ralamb", "rangerlars", "adamp", "sgdp") \
                and not host_lr
            assert schedule_step(cfg, 7) == 7 + late, (name, host_lr)


@pytest.mark.parametrize("kind", ["adamp", "sgdp"])
def test_projection_takes_the_flax_rows(kind):
    """A conv whose gradient is orthogonal to its weight within each
    torch output channel (the per-channel view of the torch reference) but
    not within each row of kernel height (flax's axis 0): the JAX package
    projects in the whole-tensor view only, and so does the port. Rows by
    torch's dim 0 would project per output channel and land elsewhere."""
    rng = np.random.RandomState(5)
    w = rng.randn(8, 4, 3, 3).astype(np.float32)          # OIHW
    g = rng.randn(8, 4, 3, 3).astype(np.float32)
    wf = w.reshape(8, -1)
    gf = g.reshape(8, -1)
    gf -= (gf * wf).sum(1, keepdims=True) / (wf * wf).sum(1, keepdims=True) \
        * wf                                              # per out channel
    g = gf.reshape(w.shape)
    jw = {"conv": jnp.asarray(w.transpose(2, 3, 1, 0))}
    jg = {"conv": jnp.asarray(g.transpose(2, 3, 1, 0))}
    opts = [f'solver.optimizer="{kind}"', "solver.weight_decay=0.05",
            "solver.base_lr=0.1", "solver.warmup_iters=0"]
    tx = j_build_opt(JConfig().apply_opts(opts), 10)
    upd, _ = tx.update(jg, tx.init(jw), jw)
    ref = np.asarray(optax.apply_updates(jw, upd)["conv"]).transpose(
        3, 2, 0, 1)
    cfg = TConfig().apply_opts(opts)
    p = torch.nn.Parameter(torch.tensor(w))
    opt = build_optimizer(cfg, _named_holder({"conv": p}))
    for group in opt.param_groups:
        group["lr"] = build_schedule(cfg, 10)(schedule_step(cfg, 0))
    p.grad = torch.tensor(g)
    opt.step()
    assert bool(opt.state[p]["projected"])
    np.testing.assert_allclose(p.detach().numpy(), ref, atol=1e-6)
    # rows along the flax layout's axis 0 only: the channel view of torch
    # dim 0 would have fired and moved the weights differently
    from rdpn6d_tpu_torch.solver.projection import cosine_ratios
    ratios = cosine_ratios(torch.tensor(w), torch.tensor(g), 0.1, 1e-8)
    assert float(ratios[0]) >= 1.0 and float(ratios[1]) < 1.0


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


def test_rangerlars_resume_is_bit_exact(tmp_path):
    """3 steps, a checkpoint, a fresh model and optimizer restored from it,
    3 more steps: bit for bit the 6 uninterrupted steps of the port's train
    step (Ralamb's moments, the Lookahead slow copy and call count, which
    syncs at step 6, and the 1-based lr all round-trip)."""
    from rdpn6d_tpu_torch.data.synthetic import dummy_train_batch
    from rdpn6d_tpu_torch.engine.checkpoint import CheckpointManager
    from rdpn6d_tpu_torch.models import init_weights
    from rdpn6d_tpu_torch.parallel import create_train_state, make_train_step

    opts = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
            "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
            "data.out_res=16", 'solver.optimizer="rangerlars"',
            "solver.weight_decay=0.01", "solver.warmup_iters=2",
            "solver.base_lr=1e-3", "solver.max_grad_norm=1.0"]
    cfg = TConfig().apply_opts(opts)
    batches = [{k: torch.from_numpy(v) for k, v in
                dummy_train_batch(cfg, 2, seed=s).items()} for s in range(6)]
    schedule = build_schedule(cfg, 20)

    def fresh():
        model = init_weights(RDPN(cfg), torch.Generator().manual_seed(0))
        return create_train_state(cfg, model, lr=schedule(0))

    step = make_train_step(cfg, schedule)
    whole = fresh()
    for b in batches:
        whole, _ = step(whole, b)
    first = fresh()
    for b in batches[:3]:
        first, _ = step(first, b)
    CheckpointManager(str(tmp_path / "ckpt")).save(3, first)
    second, _ = CheckpointManager(str(tmp_path / "ckpt")).restore(fresh())
    assert second.step == 3
    for b in batches[3:]:
        second, _ = step(second, b)
    a, b = whole.model.state_dict(), second.model.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = whole.optimizer.state_dict(), second.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["param_groups"][0]["lookahead_step"] == 6
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                sb["state"][i][k])), (i, k)
