"""The flagship network (lm13 widths: ResNet-34, 256² input, 64² head
maps, 32 regions, rot_concat) at B=2: every output key against the JAX
``RDPN``, and the weight round trip flax -> port state_dict ->
``rdpn6d_tpu.utils.torch_convert.convert_rdpn_checkpoint`` -> flax, which
pins the port's key layout to the reference checkpoint's.

Tolerance as in ``test_torch_model.py`` (float32 on both sides, sums in
other orders through 30+ layers), each key held to RTOL × its max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.models import dummy_batch
from rdpn6d_tpu.utils.torch_convert import convert_rdpn_checkpoint
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.models import RDPN as TRDPN
from rdpn6d_tpu_torch.utils.flax_params import state_dict_from_flax
from tests.test_torch_model import (
    KEYS,
    RTOL,
    assert_outputs_match,
    make_batch,
    perturb,
)

OPTS = ["backbone.rot_concat=true", 'head.init="fan_in"']


@pytest.fixture(scope="module")
def flagship():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = JConfig().apply_opts(OPTS)
    model = JRDPN(cfg, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), dummy_batch(cfg, 1),
                           train=False)
    params, stats = perturb(variables, 1)
    yield model, params, stats
    torch.set_num_threads(old)


def test_flagship_outputs_match_jax(flagship):
    model, params, stats = flagship
    batch = make_batch(model.cfg, B=2, seed=4)
    ref = model.apply({"params": params, "batch_stats": stats},
                      {k: jnp.asarray(v) for k, v in batch.items()},
                      train=False)
    ref = {k: np.asarray(ref[k]) for k in KEYS}
    cfg = TConfig().apply_opts(OPTS)
    tm = TRDPN(cfg)
    tm.load_state_dict(state_dict_from_flax(cfg, params, stats))
    tm.eval()
    with torch.no_grad():
        out = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    ours = {k: out[k].numpy() for k in KEYS}
    assert ours["mask_logits"].shape == (2, 64, 64, 1)
    assert ours["region_logits"].shape == (2, 64, 64, 33)
    assert_outputs_match(ours, ref, RTOL)


def test_flagship_weight_round_trip(flagship):
    _, params, stats = flagship
    sd = state_dict_from_flax(TConfig().apply_opts(OPTS), params, stats)
    # the port's state_dict is exactly its module tree's
    assert set(sd) == set(TRDPN(TConfig().apply_opts(OPTS)).state_dict())
    p2, s2 = convert_rdpn_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, depth=34, head_convs=6)

    def leaves(t, pre=()):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, pre + (k,))
            else:
                yield pre + (k,), np.asarray(v)

    for orig, back in ((params, p2), (stats, s2)):
        a, b = dict(leaves(orig)), dict(leaves(back))
        assert set(a) == set(b), sorted(set(a) ^ set(b))[:5]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
