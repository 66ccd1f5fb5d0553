"""``min_dist2``: the plain version vs the JAX package's XLA oracle and
its Pallas kernel in interpret mode; the wrapper's checks and dispatch.

Tolerance: the JAX side uses the expanded form |a|²−2a·b+|b|², whose
rounding error grows with the squared norms, while the port uses the direct
form. So atol = 1e-6·(max‖a‖² + max‖b‖²), a few float32 ulps of the
largest term the expanded form sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdpn6d_tpu.ops.pallas_kernels import min_dist2_pallas, min_dist2_xla
from rdpn6d_tpu_torch.ops import cuda_build
from rdpn6d_tpu_torch.ops.min_dist import (
    min_dist2,
    min_dist2_cuda,
    min_dist2_plain,
)


def _atol(a, b):
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
