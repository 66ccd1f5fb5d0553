"""``min_dist2``: the plain version vs the JAX package's XLA oracle and
its Pallas kernel in interpret mode, on finite and non-finite input; the
kernel's launch plan; the wrapper's checks and dispatch.

Tolerance: the JAX side uses the expanded form |a|²−2a·b+|b|², whose
rounding error grows with the squared norms, while the port uses the direct
form. So atol = 1e-6·(max‖a‖² + max‖b‖²) over the finite rows, a few
float32 ulps of the largest term the expanded form sums. NaN and ±inf
results must sit at the same places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdpn6d_tpu.ops.pallas_kernels import min_dist2_pallas, min_dist2_xla
from rdpn6d_tpu_torch.ops import cuda_build
from rdpn6d_tpu_torch.ops.min_dist import (
    MIN_BLOCKS_PER_SM,
    MIN_SPLIT_ROWS,
    ROWS_PER_THREAD,
    THREADS,
    launch_plan,
    min_dist2,
    min_dist2_cuda,
    min_dist2_plain,
)


def _atol(a, b):
    a = a[np.isfinite(a).all(-1)]
    b = b[np.isfinite(b).all(-1)]
    if not (a.size and b.size):
        return 0.0
    return 1e-6 * ((a * a).sum(-1).max() + (b * b).sum(-1).max())


SHAPES = [(7, 5, 0.1), (300, 700, 1.0), (1, 1, 1.0), (513, 129, 10.0),
          (64, 2000, 0.05)]


@pytest.mark.parametrize("n,m,spread", SHAPES)
def test_plain_matches_xla(n, m, spread):
    rng = np.random.RandomState(n + m)
    a = rng.randn(n, 3).astype(np.float32)
    b = (rng.randn(m, 3) * spread).astype(np.float32)
    ref = np.asarray(min_dist2_xla(jnp.asarray(a), jnp.asarray(b)))
    out = min_dist2(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert out.shape == (n,) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=_atol(a, b))


@pytest.mark.parametrize("n,m", [(7, 5), (300, 700)])
def test_plain_matches_pallas_interpret(n, m):
    rng = np.random.RandomState(1)
    a = rng.randn(n, 3).astype(np.float32)
    b = (rng.randn(m, 3) * 0.1).astype(np.float32)
    ref = np.asarray(min_dist2_pallas(jnp.asarray(a), jnp.asarray(b),
                                      interpret=True))
    out = min_dist2(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=_atol(a, b))


def test_batched_equals_per_item_and_exact_numpy():
    # metre-scale clouds ~1 m from the camera: the regime where the
    # expanded form cancels; the direct form matches float64 to 1e-7
    rng = np.random.RandomState(2)
    a = (rng.randn(4, 333, 3) * 0.05 + [0, 0, 1.0]).astype(np.float32)
    b = (rng.randn(4, 257, 3) * 0.05 + [0, 0, 1.0]).astype(np.float32)
    out = min_dist2(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    exact = ((a[:, :, None].astype(np.float64)
              - b[:, None].astype(np.float64)) ** 2).sum(-1).min(-1)
    np.testing.assert_allclose(out, exact, rtol=1e-5, atol=1e-10)
    for i in range(4):
        np.testing.assert_array_equal(
            out[i], min_dist2(torch.from_numpy(a[i]),
                              torch.from_numpy(b[i])).numpy())


@pytest.mark.parametrize("d", [1, 2, 5])
def test_plain_other_d(d):
    rng = np.random.RandomState(d)
    a = rng.randn(2, 50, d).astype(np.float32)
    b = rng.randn(2, 70, d).astype(np.float32)
    exact = ((a[:, :, None] - b[:, None]) ** 2).sum(-1).min(-1)
    np.testing.assert_allclose(
        min_dist2_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        exact, rtol=1e-6)


def test_wrapper_checks_inputs():
    a = torch.zeros(4, 3)
    with pytest.raises(TypeError):
        min_dist2(a.double(), a.double())
    with pytest.raises(ValueError):
        min_dist2(torch.zeros(4, 3), torch.zeros(4, 2))
    with pytest.raises(ValueError):
        min_dist2(torch.zeros(4, 3), torch.zeros(0, 3))
    with pytest.raises(ValueError):
        min_dist2(torch.zeros(3, 4).t(), torch.zeros(5, 3))
    # a device with no kernel raises; it never takes the plain version
    with pytest.raises(ValueError, match="no kernel"):
        min_dist2(torch.zeros(4, 3, device="meta"),
                  torch.zeros(5, 3, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        min_dist2_cuda(torch.zeros(1, 4, 3), torch.zeros(1, 5, 3))


def test_cpu_path_counts_no_launch():
    cuda_build.reset_launches()
    min_dist2(torch.zeros(4, 3), torch.ones(5, 3))
    assert cuda_build.LAUNCHES.get("min_dist2", 0) == 0


def nonfinite_inputs(case):
    """a [2,40,3], b [2,30,3] float32 with non-finite values in batch item
    1 only, and the NaN and inf counts of item 1's result. "inf" puts a at
    -inf in one row and b at +inf in one row, with every other a-row in the
    negative octant and b-row in the positive one: there every cross term
    of the expanded form is -inf, so it forms no inf - inf and both forms
    give +inf where a pair is infinitely far."""
    rng = np.random.RandomState(len(case))
    a = rng.randn(2, 40, 3).astype(np.float32)
    b = rng.randn(2, 30, 3).astype(np.float32)
    if case == "nan_b_row":
        b[1, 7, 1] = np.nan
        return a, b, 40, 0
    if case == "nan_a_row":
        a[1, 5, 2] = np.nan
        return a, b, 1, 0
    if case == "all_nan_b":
        b[1] = np.nan
        return a, b, 40, 0
    assert case == "inf"
    a[1] = -np.abs(a[1]) - 0.1
    b[1] = np.abs(b[1]) + 0.1
    a[1, 3] = -np.inf
    b[1, 4] = np.inf
    return a, b, 0, 1


NONFINITE = ["nan_b_row", "nan_a_row", "all_nan_b", "inf"]


@pytest.mark.parametrize("case", NONFINITE)
def test_nonfinite_matches_xla(case):
    """NaN propagates as ``jnp.min`` does: a NaN distance makes its row
    NaN, and nothing leaks into another batch item."""
    a, b, n_nan, n_inf = nonfinite_inputs(case)
    ref = np.stack([np.asarray(min_dist2_xla(jnp.asarray(x), jnp.asarray(y)))
                    for x, y in zip(a, b)])
    out = min_dist2(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert int(np.isnan(ref[1]).sum()) == n_nan
    assert int(np.isinf(ref[1]).sum()) == n_inf
    assert np.isfinite(ref[0]).all()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(out), np.isposinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=0,
                               atol=_atol(a.reshape(-1, 3), b.reshape(-1, 3)))


def test_inf_row_where_the_forms_part():
    """A b-row at +inf seen from a-rows with positive coordinates: the
    expanded form's cross term is +inf and inf - inf gives NaN, a NaN that
    is not in the data. The port's direct form gives the true distance,
    +inf, so each row keeps its finite nearest, as float64 numpy does."""
    rng = np.random.RandomState(3)
    a = (rng.rand(6, 3) + 0.1).astype(np.float32)
    b = rng.randn(5, 3).astype(np.float32)
    b[1] = np.inf
    assert np.isnan(np.asarray(min_dist2_xla(jnp.asarray(a),
                                             jnp.asarray(b)))).all()
    with np.errstate(invalid="ignore"):
        exact = ((a[:, None].astype(np.float64) - b[None]) ** 2).sum(-1)
    out = min_dist2(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, exact.min(-1), rtol=1e-6)


PLAN_CASES = [
    # the three path shapes: serve + score, phase 9's largest per-object
    # launch, one object of LM-13's test split
    (16, 4096, 4096, 3, 132), (8, 3000, 3000, 3, 132),
    (1000, 3000, 3000, 3, 132),
    # N around a block's THREADS * ROWS_PER_THREAD a-rows
    (1, 1023, 700, 3, 132), (1, 1024, 700, 3, 132), (2, 1025, 700, 3, 132),
    (3, 2049, 255, 3, 132),
    # M around the 256-row stage chunk and two splits' worth of rows
    (2, 5, 256, 3, 132), (3, 100, 257, 3, 132), (1, 7, 513, 3, 132),
    (1, 300, 127, 3, 132), (1, 300, 128, 3, 132), (1, 300, 129, 3, 132),
    # N = 1, M = 1
    (1, 1, 5000, 3, 132), (4, 300, 1, 3, 132),
    # a card of one SM
    (8, 3000, 3000, 3, 1), (1, 300, 5000, 3, 1), (1, 1, 1, 3, 1),
    # the plain path of D != 3
    (3, 129, 1000, 5, 132), (2, 50, 70, 1, 1),
]


@pytest.mark.parametrize("B,N,M,D,sms", PLAN_CASES)
def test_launch_plan_covers_each_pair_once(B, N, M, D, sms):
    plan = launch_plan(B, N, M, D, sms)
    assert plan.threads == THREADS
    assert plan.rows_per_thread == (ROWS_PER_THREAD if D == 3 else 1)
    # every block is one (batch, split, tile) and every one has a block
    ids = {plan.block(i) for i in range(plan.blocks)}
    assert len(ids) == plan.blocks == B * plan.splits * plan.tiles
    assert ids == {(i, s, t) for i in range(B) for s in range(plan.splits)
                   for t in range(plan.tiles)}
    # the tiles cover every a-row exactly once, and no tile is empty
    rows = [plan.a_rows(t) for t in range(plan.tiles)]
    assert all(r.size for r in rows)
    np.testing.assert_array_equal(np.sort(np.concatenate(rows)),
                                  np.arange(N))
    # the splits tile [0, M): no gap, no overlap, no empty split
    ranges = [plan.b_range(s) for s in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == M
    assert all(lo < hi for lo, hi in ranges)
    assert all(x[1] == y[0] for x, y in zip(ranges, ranges[1:]))
    # b is split exactly when the unsplit grid under-fills the SMs and b
    # has rows for two splits
    base = B * plan.tiles
    under = D == 3 and base < MIN_BLOCKS_PER_SM * sms \
        and M >= 2 * MIN_SPLIT_ROWS
    assert (plan.splits > 1) == under
    if under:
        assert plan.split_rows >= MIN_SPLIT_ROWS
        assert plan.blocks >= min(MIN_BLOCKS_PER_SM * sms,
                                  base * (M // MIN_SPLIT_ROWS)) * 0.9


@pytest.mark.parametrize("B,N,M,splits,blocks", [
    (16, 4096, 4096, 10, 640), (8, 3000, 3000, 22, 528),
    (1000, 3000, 3000, 1, 3000)])
def test_launch_plan_at_path_shapes(B, N, M, splits, blocks):
    """On the H100's 132 SMs: serve + score splits b ten ways (640 blocks,
    4.8 an SM), the eval smoke's largest object 22 ways (528 blocks, 4 an
    SM), and a full split's object fills the card unsplit."""
    plan = launch_plan(B, N, M, 3, 132)
    assert (plan.splits, plan.blocks) == (splits, blocks)


@pytest.mark.parametrize("d", [3, 5])
def test_launch_plan_refuses_a_grid_too_large(d):
    with pytest.raises(ValueError, match="grid"):
        launch_plan(2**31, 1, 1, d, 132)
