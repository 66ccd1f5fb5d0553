"""``ralamb`` in the port's float64 train step against the JAX package's,
under both ``solver.host_lr`` values (``tests/torch_opt_steps.py`` has the
comparison and its tolerances). Without ``host_lr`` the JAX package's
ralamb reads the schedule at its 1-based count, one step later than the
optax chains; with it, the trainer's injected ``schedule(it)``. At the
2-step warm-up the two lrs of the first step differ ~500x."""

import pytest
import torch

from tests.torch_opt_steps import check_step_matches_jax, make_init


@pytest.fixture(scope="module")
def init():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield make_init()
    torch.set_num_threads(old)


@pytest.mark.parametrize("host_lr", [False, True])
def test_ralamb_step_matches_jax(host_lr, init):
    check_step_matches_jax("ralamb", host_lr, init)
