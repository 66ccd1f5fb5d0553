"""The port's data-parallel train step and BatchNorm on two gloo ranks of
the CPU (``rdpn6d_tpu_torch.parallel``), against the JAX package's sharded
step on a 2-device mesh of conftest's virtual CPU devices and against the
port's one-process step on the global batch.

The step runs at the tiny configuration of ``test_torch_train_step.py``
(ResNet-18 on 64² ROIs: BatchNorm in the trunk, the head and the point
net), global batch 4 (2 ROIs a rank), 3 steps, in float64 on every side,
from the same flax init: in float32 this network at init is
ill-conditioned (that file's docstring), and the two ranks' BatchNorm,
which combines per-rank moments, rounds differently from the one
process's fused kernel: measured in float32, ``grad_norm`` 2.4e-5 apart
after the first step and 3.3e-3 after the third. Cases: the fixture's
batches, the same with rank 1's ROIs all without mask pixels (per-rank
normalisers would clamp there and give another gradient), and DropBlock
on (port against port: JAX draws with its own generator).

Tolerances. Against JAX, those of ``test_torch_train_step.py``: every
loss within 1e-6 and ``grad_norm`` within 1e-5 relative at every step,
every parameter and BatchNorm statistic within 1e-2 of its leaf's change
over the run. Against the one-process step: every loss and ``grad_norm``
within 1e-5 relative, the first step's gradient sums within 1e-5 of the
largest gradient, every parameter and running statistic within 1e-5 of
its leaf's largest value (measured: ~1e-13), or of 1 for the biases that
feed a batch-statistics BatchNorm, whose values are rounding (~1e-20).
The two ranks end bit-equal.

``BatchNorm2d`` alone is held in float32 and under bf16 autocast: each
rank's rows of the output and the input gradient, the ranks' summed
weight and bias gradients and the running statistics against one process
on the concatenated input: float32 within 1e-5 (the per-rank moments are
combined, the one process's taken at once), bf16 outputs within one bf16
ulp of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.parallel import create_mesh, replicate
from rdpn6d_tpu.parallel import create_train_state as j_create_state
from rdpn6d_tpu.parallel import make_sharded_train_step as j_sharded_step
from rdpn6d_tpu.solver import build_optimizer as j_build_opt
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data.synthetic import dummy_train_batch
from rdpn6d_tpu_torch.parallel import make_sharded_train_step, spawn
from rdpn6d_tpu_torch.utils.flax_params import state_dict_from_flax

STEPS = 3
B = 4
TOTAL_ITERS = 100
TINY = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16", 'head.init="fan_in"', "solver.warmup_iters=2",
        "solver.base_lr=2e-5", "loss.use_mtl=true"]
CASES = {"plain": [], "empty_mask": [], "dropblock": ["pnp.drop_prob=0.2"]}
# conv biases right before a batch-statistics BatchNorm: zero gradient
BN_CANCELLED = ("backbone.spatial_net.xyz_emb.bias",
                "backbone.spatial_net.conv1.bias",
                "backbone.spatial_net.conv2.bias",
                "backbone.spatial_net.conv3.bias")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _batches(case):
    cfg = TConfig().apply_opts(TINY)
    out = []
    for s in range(STEPS):
        b = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in dummy_train_batch(cfg, B, seed=s).items()}
        if case == "empty_mask":
            for k in ("roi_mask_trunc", "roi_mask_visib", "roi_mask_obj"):
                b[k][B // 2:] = 0.0
        out.append(b)
    return out


@pytest.fixture(scope="module")
def flax_init():
    with jax.enable_x64(True):
        model = JRDPN(JConfig().apply_opts(TINY), dtype=jnp.float64)
        b = {k: jnp.asarray(v) for k, v in _batches("plain")[0].items()}
        v = jax.jit(lambda key, b: model.init(key, b, train=False))(
            jax.random.PRNGKey(0), b)
        return jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float64)
            if x.dtype == jnp.float32 else np.asarray(x),
            jax.device_get(v))


@pytest.fixture(scope="module")
def jax_runs(flax_init):
    """The JAX package's sharded step on a 2-device mesh, float64, for the
    plain and the empty-mask batches (one compile)."""
    runs = {}
    with jax.enable_x64(True):
        cfg = JConfig().apply_opts(TINY)
        model = JRDPN(cfg, dtype=jnp.float64)
        tx = j_build_opt(cfg, total_iters=TOTAL_ITERS)
        mesh = create_mesh(2)
        step = j_sharded_step(cfg, model, tx, mesh)
        for case in ("plain", "empty_mask"):
            # placed as the step's outputs are, so that it compiles once
            state = replicate(j_create_state(
                cfg, jax.tree_util.tree_map(jnp.asarray, flax_init), tx),
                mesh)
            metrics = []
            for b in _batches(case):
                state, m = step(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
                metrics.append({k: float(v) for k, v in m.items()})
            runs[case] = {"metrics": metrics,
                          "params": jax.device_get(state.params),
                          "stats": jax.device_get(state.batch_stats)}
    return runs


def _opts(case):
    return TINY + ["solver.amp=false"] + CASES[case]


def _init_state_dict(flax_init):
    return {k: v.double() if v.is_floating_point() else v
            for k, v in state_dict_from_flax(
                TConfig().apply_opts(TINY), flax_init["params"],
                flax_init["batch_stats"]).items()}


def _bn_inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(6, 5, 4, 3) * 2 + 3).astype(np.float32)
    return (x, rng.uniform(0.5, 1.5, 5).astype(np.float32),
            rng.randn(5).astype(np.float32),
            rng.randn(*x.shape).astype(np.float32))


BN_CALLS = [("batchnorm", _bn_inputs(), {"autocast": a})
            for a in (False, True)]


@pytest.fixture(scope="module")
def port_runs(flax_init):
    """Every step case, the BatchNorm cases and the collectives on two
    gloo ranks (one spawn); the step and BatchNorm cases also in this
    process on the global batch."""
    sd = _init_state_dict(flax_init)
    calls = [("train_steps", (_opts(c), sd, _batches(c), TOTAL_ITERS,
                              torch.float64), {}) for c in CASES]
    ranks = spawn(workers.several, 2, device="cpu",
                  args=(calls + BN_CALLS + [("collectives", (), {})],))
    n = len(CASES)
    return {"ranks": [dict(zip(CASES, r[:n])) for r in ranks],
            "one": dict(zip(CASES, workers.several("cpu", calls))),
            "init": sd,
            "bn": [r[n:n + len(BN_CALLS)] for r in ranks],
            "bn_one": workers.several("cpu", BN_CALLS),
            "collectives": [r[-1] for r in ranks]}


@pytest.mark.parametrize("case", ["plain", "empty_mask"])
def test_two_ranks_match_jax_sharded_step(case, jax_runs, port_runs):
    ref = jax_runs[case]
    ours = port_runs["ranks"][0][case]
    for i, (m, r) in enumerate(zip(ours["metrics"], ref["metrics"])):
        assert set(m) == set(r), i
        for k, v in r.items():
            tol = 1e-5 if k == "grad_norm" else 1e-6
            assert abs(m[k] - v) <= tol * max(abs(v), 1e-3), (i, k, m[k], v)
    cfg = TConfig().apply_opts(_opts(case))
    want = state_dict_from_flax(cfg, ref["params"], ref["stats"])
    start, got = port_runs["init"], ours["state"]
    moved = 0
    for k, v in want.items():
        if k.endswith("num_batches_tracked") or k in BN_CANCELLED:
            continue
        change = float((v.double() - start[k]).abs().max())
        err = float((got[k] - v.double()).abs().max())
        assert change > 0, k
        assert err <= 1e-2 * change, (k, err, change)
        moved += 1
    assert moved > 100


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_one_process_on_the_global_batch(case, port_runs):
    one = port_runs["one"][case]
    r0, r1 = (port_runs["ranks"][r][case] for r in range(2))
    for i, (m, ref) in enumerate(zip(r0["metrics"], one["metrics"])):
        for k, v in ref.items():
            assert abs(m[k] - v) <= 1e-5 * max(abs(v), 1e-3), (i, k, m[k], v)
        assert m == r1["metrics"][i]
    top = max(float(g.abs().max()) for g in one["grads"].values())
    assert set(r0["grads"]) == set(one["grads"])
    for k, g in one["grads"].items():
        assert float((r0["grads"][k] - g).abs().max()) <= 1e-5 * top, k
        assert torch.equal(r0["grads"][k], r1["grads"][k]), k
    for k, v in one["state"].items():
        assert torch.equal(r0["state"][k], r1["state"][k]), k
        if v.is_floating_point():
            # the BN-cancelled biases are rounding of order 1e-20
            scale = 1.0 if k in BN_CANCELLED else float(v.abs().max())
            err = float((r0["state"][k] - v).abs().max())
            assert err <= 1e-5 * scale, (k, err)
        else:
            assert torch.equal(r0["state"][k], v), k
    if case == "empty_mask":
        # the normalisers are the global batch's: rank 1 holds no mask
        # pixel, so a per-rank clamp would have made its losses count
        assert all(np.isfinite(list(m.values())).all()
                   for m in r0["metrics"])


def test_sharded_step_needs_a_group():
    cfg = TConfig().apply_opts(TINY)
    with pytest.raises(RuntimeError, match="process group"):
        make_sharded_train_step(cfg, lambda it: 0.0)


def test_batchnorm_over_two_ranks_is_the_global_batch_norm(port_runs):
    for i, autocast in enumerate((False, True)):
        one = port_runs["bn_one"][i]
        got = [port_runs["bn"][r][i] for r in range(2)]
        y = torch.cat([g["y"] for g in got])
        dx = torch.cat([g["dx"] for g in got])
        dw, db = got[0]["dw"] + got[1]["dw"], got[0]["db"] + got[1]["db"]
        if autocast:
            assert got[0]["dtype"] == one["dtype"] == "torch.bfloat16"
            ulp = float(one["y"].abs().max()) * 2.0 ** -7
            assert float((y - one["y"]).abs().max()) <= ulp
            tol = 1e-4
        else:
            assert got[0]["dtype"] == one["dtype"] == "torch.float32"
            np.testing.assert_allclose(y, one["y"], rtol=0, atol=1e-5)
            tol = 1e-5
        np.testing.assert_allclose(dx, one["dx"], rtol=tol, atol=tol)
        np.testing.assert_allclose(dw, one["dw"], rtol=tol, atol=tol)
        np.testing.assert_allclose(db, one["db"], rtol=tol, atol=tol)
        for k in ("mean", "var"):
            assert torch.equal(got[0][k], got[1][k]), k
            np.testing.assert_allclose(got[0][k], one[k], rtol=1e-6,
                                       atol=1e-6)


def test_collectives_sum_gather_and_replicate(port_runs):
    for r, got in enumerate(port_runs["collectives"]):
        # y = sum_q x_q (q + 2) = 1*2 + 2*3; dL/dx_r = (r + 2) sum_q (q + 1)
        assert torch.equal(got["y"], torch.full((3,), 8.0))
        assert torch.equal(got["dx"], torch.full((3,), 3.0 * (r + 2)))
        assert got["gathered"] == ["r0a", "r0b", "r1a", "r1b"]
        assert torch.equal(got["weight"], torch.zeros(2, 2))
