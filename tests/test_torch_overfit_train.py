"""``tools.overfit_synth --small --steps 3`` against the JAX package's
``tools/overfit_synth.py`` at the same flags:

  * the config: the port's overrides are the JAX tool's (read from its
    ``main``), plus ``solver.amp=false``, since the JAX tool's small model
    runs in float32;
  * the training: the port's ``run`` (scenes, ``Trainer`` with its
    checkpoints and writers, the eval) from the JAX tool's initial weights
    (``model.init`` on its batch, carried by ``utils/flax_params``) and on
    the JAX tool's preprocessed batch (``build_scenes``; the two packages'
    scenes are held to each other in ``test_torch_overfit.py``), against
    the JAX package's train step under the JAX tool's schedule and
    optimizer, as its ``Trainer`` builds them, for 3 steps.

Both sides train in float64 (``jax.enable_x64``, the port's model
``.double()``), as ``test_torch_train_step.py`` does and for its reason:
in float32 this tiny network at init is ill-conditioned (the second
step's PM loss parts by 3e-4 relative on rounding alone). The first step,
from equal weights, has that test's bounds: every loss within 1e-6
relative (of at least 1e-3) and ``grad_norm`` within 1e-5 (measured:
2.8e-8 and 4.6e-7). Later steps start from weights that differ by the
JAX step's float32 pieces (its schedule gives 3.0000004e-7 for 3e-7, its
clip), which this init amplifies at the tool's lr: ``grad_norm`` parts
by 1.8e-3 at the second step in float64 too. So steps 2 and 3 hold every
loss within 1e-3 relative (measured: 5.1e-4), and hold the tool's own
training to the port's ``make_train_step`` on the same batch and weights
bit for bit: the tool adds nothing to the step.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rdpn6d_tpu.config as jconfig
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.parallel import create_train_state as j_create_state
from rdpn6d_tpu.parallel import make_train_step as j_make_step
from rdpn6d_tpu.solver import build_optimizer as j_build_opt
from rdpn6d_tpu.solver import build_schedule as j_build_schedule
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.models import RDPN
from rdpn6d_tpu_torch.parallel import create_train_state, make_train_step
from rdpn6d_tpu_torch.solver import build_schedule
from rdpn6d_tpu_torch.tools import overfit_synth
from rdpn6d_tpu_torch.utils.flax_params import state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--small", "--steps", "3", "--n-views", "4", "--seed", "0"]
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _Stop(Exception):
    pass


def jax_tool_opts(monkeypatch, argv):
    """The overrides the JAX tool's ``main`` applies for ``argv``, and the
    tool's module."""
    spec = importlib.util.spec_from_file_location(
        "jax_tool_overfit_synth",
        os.path.join(ROOT, "tools", "overfit_synth.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    seen = []

    def record(self, opts):
        seen.append(list(opts))
        raise _Stop

    with monkeypatch.context() as m:
        m.setattr(jconfig.Config, "apply_opts", record)
        m.setattr(sys, "argv", ["overfit_synth", *argv])
        with pytest.raises(_Stop):
            jmod.main()
    return seen[0], jmod


def test_small_three_steps_match_jax(tmp_path, monkeypatch, capsys):
    args = overfit_synth.parse_args([*ARGV, "--out", str(tmp_path),
                                     "--device", "cpu"])
    opts = overfit_synth.config_opts(args)
    j_opts, jmod = jax_tool_opts(monkeypatch, [*ARGV, "--out",
                                               str(tmp_path)])
    assert opts == j_opts + ["solver.amp=false"]

    # the JAX side: the tool's batch and init, the Trainer's step
    jcfg = jconfig.Config().apply_opts(j_opts)
    jbatch, _, _ = jmod.build_scenes(jcfg, args.n_views,
                                     jcfg.head.num_regions, seed=0)
    batch = {k: np.asarray(v, np.float64) if v.dtype == np.float32
             else np.asarray(v) for k, v in jax.device_get(jbatch).items()}
    with jax.enable_x64(True):
        model = JRDPN(jcfg, dtype=jnp.float64)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        variables = jax.device_get(jax.jit(
            lambda key, b: model.init(key, b, train=False))(
                jax.random.PRNGKey(args.seed), jb))
        tx = j_build_opt(jcfg, STEPS,
                         schedule=j_build_schedule(jcfg, STEPS))
        state = j_create_state(jcfg, variables, tx)
        step = j_make_step(jcfg, model, tx)
        j_metrics = []
        for _ in range(STEPS):
            state, m = step(state, jb)
            j_metrics.append({k: float(v) for k, v in m.items()})

    # the port's tool on the same batch and weights
    tcfg = TConfig().apply_opts(opts)
    held = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    held = {k: v.long() if v.dtype == torch.int32 else v
            for k, v in held.items()}
    t_build = overfit_synth.build_scenes

    def same_batch(*a, **kw):
        _, pts, poses = t_build(*a, **kw)
        return held, pts, poses

    def carried(m):
        m.double().load_state_dict(state_dict_from_flax(
            tcfg, variables["params"], variables["batch_stats"]))

    monkeypatch.setattr(overfit_synth, "build_scenes", same_batch)
    out = overfit_synth.run(args, init=carried)
    text = capsys.readouterr().out

    assert len(out["losses"]) == STEPS
    for i, (t, j) in enumerate(zip(out["losses"], j_metrics)):
        keys = [k for k in j if k.startswith("loss_")]
        assert len(keys) >= 4 and set(keys) <= set(t)
        tol = 1e-6 if i == 0 else 1e-3
        for k in keys + ["total_loss"]:
            assert abs(t[k] - j[k]) <= tol * max(abs(j[k]), 1e-3), \
                (i, k, t[k], j[k])
        if i == 0:
            assert abs(t["grad_norm"] - j["grad_norm"]) \
                <= 1e-5 * j["grad_norm"]

    # the tool's training is the port's train step, bit for bit
    model = RDPN(tcfg)
    carried(model)
    schedule = build_schedule(tcfg, STEPS)
    state = create_train_state(tcfg, model, lr=schedule(0))
    step = make_train_step(tcfg, schedule)
    for i in range(STEPS):
        state, m = step(state, held)
        assert {k: float(v) for k, v in m.items()} == out["losses"][i], i
    assert [ln.split(" ")[0] for ln in text.splitlines()
            if ln.startswith("RESULT[")] == ["RESULT[bf16]"]
    assert set(out["results"]) == {"bf16"}
    # the trainer checkpointed, its last step among them
    assert str(STEPS) in os.listdir(tmp_path / "ckpt")
