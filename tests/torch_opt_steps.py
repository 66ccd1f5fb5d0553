"""The float64 train-step comparison of
``tests/test_torch_train_step_adamp.py`` and ``..._ralamb.py``: the
port's train step against the JAX package's with the projection and
trust-ratio optimizers, 7 steps of ``make_train_step`` in float64 at
``tests/test_torch_train_step.py``'s tiny configuration (ResNet-18 on 64²
ROIs), from the same flax init, on the same 7 seeded batches, under both
``solver.host_lr`` values.

``adamp`` projects real model leaves: a conv feeding a BatchNorm has a
gradient orthogonal to each of its output channels, so torch's per-channel
view would project there, while the JAX package's rows (flax's axis 0,
the kernel height) do not, and its whole-tensor view does. ``ralamb``
reads the schedule at its 1-based count without ``host_lr`` and at the
trainer's injected ``schedule(it)`` with it; at a 2-step warm-up the two
differ ~500x on the first step. With ``host_lr`` the JAX side gets the
schedule's float32 table written into its injected hyperparameter each
step, as its trainer does.

Tolerance, ``test_torch_train_step.py``'s: after the last step every
parameter and BatchNorm statistic within 1e-2 of its leaf's total change
over the run (the conv biases before a batch-statistics BatchNorm, whose
gradient is rounding, aside); every loss within 1e-6 relative at every
step. One exception: an adaptive step divides each element by its own
root mean square, so an element whose gradient is within rounding of zero
(~1e-8 of its leaf's largest; the two sides' gradients differ by up to
1e-5 of it) steps about ±lr on either side, whichever its sign. Measured
at adamp's first step: 4 of the 2.36M elements of
``backbone.layer4.0.conv2.weight``, at |g| 3e-9 to 5e-8 of a 0.9 maximum.
So at most 1e-4 of a leaf's elements (one, in a leaf under 10k) may lie
outside the bound, and every leaf's L2 distance is within 1e-2 of its L2
change. ``check_steps_from_jax`` holds each step's change to the same
bounds, and each step's loss to 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.parallel import create_train_state as j_create_state
from rdpn6d_tpu.parallel import make_train_step as j_make_step
from rdpn6d_tpu.solver import build_optimizer as j_build_opt
from rdpn6d_tpu.solver import build_schedule as j_build_schedule
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.models import RDPN
from rdpn6d_tpu_torch.parallel import create_train_state, make_train_step
from rdpn6d_tpu_torch.solver import build_schedule
from rdpn6d_tpu_torch.utils.flax_params import (
    grads_from_flax,
    state_dict_from_flax,
)
from tests.test_torch_train_step import (
    BN_CANCELLED,
    STEPS,
    TINY,
    TOTAL_ITERS,
    _batches,
    _f64,
)

def _opts(name, host_lr):
    return TINY + [f'solver.optimizer="{name}"', "solver.weight_decay=0.01",
                   f"solver.host_lr={str(host_lr).lower()}"]


def make_init():
    """The flax init (jitted) and the 7 batches, in float64."""
    with jax.enable_x64(True):
        cfg = JConfig().apply_opts(TINY)
        model = JRDPN(cfg, dtype=jnp.float64)
        batches = [_f64(b) for b in _batches(TConfig().apply_opts(TINY))]
        variables = jax.jit(lambda key, b: model.init(key, b, train=False))(
            jax.random.PRNGKey(0),
            {k: jnp.asarray(v) for k, v in batches[0].items()})
        return _f64(jax.device_get(variables)), batches


def _jax_run(name, host_lr, init):
    variables, batches = init
    with jax.enable_x64(True):
        cfg = JConfig().apply_opts(_opts(name, host_lr))
        model = JRDPN(cfg, dtype=jnp.float64)
        tx = j_build_opt(cfg, total_iters=TOTAL_ITERS)
        table = np.asarray(jax.vmap(j_build_schedule(cfg, TOTAL_ITERS))(
            jnp.arange(TOTAL_ITERS, dtype=jnp.float32)))
        state = j_create_state(
            cfg, jax.tree_util.tree_map(jnp.asarray, variables), tx)
        step = j_make_step(cfg, model, tx)
        losses = []
        for i, b in enumerate(batches):
            if host_lr:
                opt = state.opt_state
                state = state.replace(opt_state=opt._replace(hyperparams={
                    **opt.hyperparams,
                    "learning_rate": np.float32(table[i])}))
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["total_loss"]))
        return (jax.device_get(state.params),
                jax.device_get(state.batch_stats), losses)


def _torch_run(name, host_lr, init):
    variables, batches = init
    cfg = TConfig().apply_opts(_opts(name, host_lr) + ["solver.amp=false"])
    model = RDPN(cfg).double()
    model.load_state_dict(state_dict_from_flax(
        cfg, variables["params"], variables["batch_stats"]))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    schedule = build_schedule(cfg, TOTAL_ITERS)
    state = create_train_state(cfg, model, lr=schedule(0))
    step = make_train_step(cfg, schedule)
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        losses.append(float(m["total_loss"]))
    return cfg, model, state, start, losses


def check_step_matches_jax(name, host_lr, init):
    params, stats, j_losses = _jax_run(name, host_lr, init)
    cfg, model, state, start, losses = _torch_run(name, host_lr, init)
    assert state.step == STEPS
    for i, (a, b) in enumerate(zip(losses, j_losses)):
        assert abs(a - b) <= 1e-6 * max(abs(b), 1e-3), (i, a, b)
    ref = state_dict_from_flax(cfg, params, stats)
    ours = model.state_dict()
    moved = 0
    for k, v in ref.items():
        if k.endswith("num_batches_tracked") or \
                k[:-len(".bias")] + ".bias" in BN_CANCELLED:
            continue
        _leaf_close(ours[k], v.double(), start[k], k, "after the last step")
        moved += 1
    assert moved > 100
    return model, state


def _leaf_close(ours, ref, start, k, what):
    change = float((ref - start).abs().max())
    assert change > 0, (what, k)
    outside = int(((ours - ref).abs() > 1e-2 * change).sum())
    assert outside <= max(1, 1e-4 * ref.numel()), (what, k, outside,
                                                   ref.numel())
    l2 = float(torch.linalg.vector_norm(ours - ref))
    assert l2 <= 1e-2 * float(torch.linalg.vector_norm(ref - start)), \
        (what, k, l2)


def _moments(opt_state):
    """The (count, mu, nu) state inside an optax state (under
    inject_hyperparams' ``inner_state`` with ``host_lr``)."""
    while not hasattr(opt_state, "mu"):
        opt_state = opt_state.inner_state
    return opt_state


def check_steps_from_jax(name, host_lr, init):
    """Each of the 7 steps taken by the port from the JAX package's state
    before it (parameters, BatchNorm statistics, Adam moments and step
    count mapped by ``utils/flax_params``), against the JAX step's result:
    the port's own forward, backward, lr and projection decisions a step.
    Returns the names of the tensors the port projected at some step."""
    variables, batches = init
    projected = set()
    with jax.enable_x64(True):
        jcfg = JConfig().apply_opts(_opts(name, host_lr))
        jmodel = JRDPN(jcfg, dtype=jnp.float64)
        tx = j_build_opt(jcfg, total_iters=TOTAL_ITERS)
        table = np.asarray(jax.vmap(j_build_schedule(jcfg, TOTAL_ITERS))(
            jnp.arange(TOTAL_ITERS, dtype=jnp.float32)))
        jstate = j_create_state(
            jcfg, jax.tree_util.tree_map(jnp.asarray, variables), tx)
        jstep = j_make_step(jcfg, jmodel, tx)
        cfg = TConfig().apply_opts(_opts(name, host_lr)
                                   + ["solver.amp=false"])
        model = RDPN(cfg).double()
        schedule = build_schedule(cfg, TOTAL_ITERS)
        state = create_train_state(cfg, model)
        step = make_train_step(cfg, schedule)
        named = dict(model.named_parameters())
        for i, b in enumerate(batches):
            before = jax.device_get((jstate.params, jstate.batch_stats))
            model.load_state_dict(state_dict_from_flax(cfg, *before))
            if i:
                mom = jax.device_get(_moments(jstate.opt_state))
                mu, nu = grads_from_flax(cfg, mom.mu), \
                    grads_from_flax(cfg, mom.nu)
                for n, p in named.items():
                    state.optimizer.state[p].update(
                        step=i, exp_avg=mu[n].double().clone(),
                        exp_avg_sq=nu[n].double().clone())
            state.step = i
            start = {k: v.clone() for k, v in model.state_dict().items()}
            if host_lr:
                opt = jstate.opt_state
                jstate = jstate.replace(opt_state=opt._replace(hyperparams={
                    **opt.hyperparams,
                    "learning_rate": np.float32(table[i])}))
            jstate, m = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in b.items()})
            state, tm = step(state, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
            ref_loss = float(m["total_loss"])
            assert abs(float(tm["total_loss"]) - ref_loss) <= \
                1e-6 * max(abs(ref_loss), 1e-3), (i, float(tm["total_loss"]),
                                                    ref_loss)
            ref = state_dict_from_flax(cfg, *jax.device_get(
                (jstate.params, jstate.batch_stats)))
            ours = model.state_dict()
            for k, v in ref.items():
                if k.endswith("num_batches_tracked") or \
                        k[:-len(".bias")] + ".bias" in BN_CANCELLED:
                    continue
                _leaf_close(ours[k], v.double(), start[k], k, f"step {i}")
            projected |= {n for n, p in named.items()
                          if bool(state.optimizer.state[p].get(
                              "projected", False))}
    return projected
