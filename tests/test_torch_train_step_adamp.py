"""``adamp`` in the port's float64 train step against the JAX package's,
under both ``solver.host_lr`` values (``tests/torch_opt_steps.py`` has the
comparison and its tolerances). AdamP projects real model leaves along
the flax layout's axis 0: a conv feeding a BatchNorm has a gradient
orthogonal to each of its output channels, so rows along torch's dim 0
would project there per channel, while the JAX package's rows (the kernel
height) do not and its whole-tensor view does.

Each of the 7 steps starts from the JAX package's state before it
(``check_steps_from_jax``): free-running, the two float64 trajectories
part after the third step. Adam divides each element by its own root
mean square, so elements whose gradient is within the two sides' rounding
of zero step either way; at the third step 10k of layer4's 2.36M conv
weights were already beyond the bound, the fourth loss 2.5e-5 apart, the
seventh's 1e-3. Started from the same state, each step holds."""

import pytest
import torch

from tests.torch_opt_steps import check_steps_from_jax, make_init


@pytest.fixture(scope="module")
def init():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield make_init()
    torch.set_num_threads(old)


@pytest.mark.parametrize("host_lr", [False, True])
def test_adamp_step_matches_jax(host_lr, init):
    projected = check_steps_from_jax("adamp", host_lr, init)
    assert any(n.startswith("backbone.layer") for n in projected), projected
