"""The port's norms under a bfloat16 model against flax's, on the CPU.

The JAX package keeps every norm's parameters and statistics float32 under
a bfloat16 model (``BatchNorm`` / ``GroupNorm(dtype=bf16,
param_dtype=f32)``, float32 ``batch_stats``), normalises in float32 and
rounds once to bfloat16. The port's ``BatchNorm2d`` and the GroupNorm of
``make_norm`` keep theirs float32 under ``.to(torch.bfloat16)`` and do the
same. Tolerance: at most 1 bfloat16 ulp, on at most 1e-3 of the elements
(float32 sums in another order move an output across a bfloat16 rounding
boundary now and then). A port that casts its norms to bfloat16 with the
model (as the port did before its norms kept float32) fails every case
here: 35.7% of the 256-channel BN's outputs differ, by up to 0.5
absolute, where the statistics are rounded to bfloat16.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from rdpn6d_tpu_torch.config import Config
from rdpn6d_tpu_torch.models import RDPN
from rdpn6d_tpu_torch.models.heads import DenseHead
from rdpn6d_tpu_torch.models.norm import BatchNorm2d, make_norm

MAX_ULPS = 1
MAX_SHARE = 1e-3


def _ordered(x: np.ndarray) -> np.ndarray:
    """bfloat16 values (as float32) to integers in the order of their
    values, one step an ulp."""
    bits = (x.astype(np.float32).view(np.uint32) >> 16).astype(np.int32)
    return np.where(bits >= 0x8000, 0x8000 - bits, bits)


def _assert_within_an_ulp(got: np.ndarray, want: np.ndarray) -> None:
    ulps = np.abs(_ordered(got) - _ordered(want))
    share = float((ulps > 0).mean())
    msg = (f"{share:.4%} of the outputs differ, by up to {ulps.max()} bf16 "
           f"ulps ({float(np.abs(got - want).max()):.3g} absolute)")
    assert ulps.max() <= MAX_ULPS and share <= MAX_SHARE, msg


def _input(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) * rng.uniform(0.5, 4.0, shape[-1]) \
        + rng.randn(shape[-1])
    # bfloat16-exact, so both sides see one input
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _to_port(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        x_nhwc.transpose(0, 3, 1, 2))).to(torch.bfloat16)


def _from_port(y: torch.Tensor) -> np.ndarray:
    return y.float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("C,seed", [(256, 0), (64, 1), (33, 2)])
def test_batchnorm_bf16_matches_flax(C, seed):
    rng = np.random.RandomState(100 + seed)
    stats = {"mean": rng.randn(C).astype(np.float32) * 0.7,
             "var": (rng.rand(C) * 3 + 0.05).astype(np.float32)}
    params = {"scale": (rng.randn(C) * 1.5).astype(np.float32),
              "bias": rng.randn(C).astype(np.float32)}
    x = _input((4, 16, 16, C), seed)
    jbn = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                        dtype=jnp.bfloat16, param_dtype=jnp.float32)
    want = np.asarray(jax.jit(jbn.apply)(
        {"params": params, "batch_stats": stats},
        jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))

    bn = BatchNorm2d(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    bn = bn.to(torch.bfloat16).eval()
    with torch.no_grad():
        y = bn(_to_port(x))
    assert y.dtype == torch.bfloat16
    _assert_within_an_ulp(_from_port(y), want)


@pytest.mark.parametrize("C,G,seed", [(128, 32, 3), (64, 8, 4)])
def test_groupnorm_bf16_matches_flax(C, G, seed):
    rng = np.random.RandomState(200 + seed)
    params = {"scale": (rng.randn(C) * 1.5).astype(np.float32),
              "bias": rng.randn(C).astype(np.float32)}
    x = _input((3, 8, 8, C), seed)
    jgn = fnn.GroupNorm(num_groups=G, dtype=jnp.bfloat16,
                        param_dtype=jnp.float32)
    want = np.asarray(jax.jit(jgn.apply)(
        {"params": params}, jnp.asarray(x, jnp.bfloat16)).astype(
        jnp.float32))

    gn = make_norm("GN", C, G)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(params["scale"]))
        gn.bias.copy_(torch.from_numpy(params["bias"]))
    gn = gn.to(torch.bfloat16)
    with torch.no_grad():
        y = gn(_to_port(x))
    assert y.dtype == torch.bfloat16
    _assert_within_an_ulp(_from_port(y), want)


@pytest.mark.parametrize("norm", ["BN", "GN"])
def test_bf16_cast_keeps_norms_float32(norm):
    """``.to(torch.bfloat16)`` of a whole model leaves every norm's
    parameters and buffers float32 (BatchNorm's counter int64), while the
    convolutions are cast; the state dict keeps its keys."""
    cfg = Config().apply_opts(["backbone.depth=18", "head.num_filters=32",
                               "head.num_layers=1",
                               f'head.norm="{norm}"'])
    model = RDPN(cfg)
    keys = list(model.state_dict())
    model = model.to(torch.bfloat16)
    assert list(model.state_dict()) == keys
    assert model.dtype == torch.bfloat16
    n = 0
    for m in model.modules():
        if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm)):
            for name, t in list(m.named_parameters()) \
                    + list(m.named_buffers()):
                want = torch.int64 if name == "num_batches_tracked" \
                    else torch.float32
                assert t.dtype == want, (m, name, t.dtype)
            n += 1
    assert n > 0
    assert model.rot_head_net.features[-1].weight.dtype == torch.bfloat16


def test_folded_constants_follow_the_statistics():
    """``BatchNorm2d.folded`` is flax's (var + eps) then rsqrt then times
    the weight, with the rsqrt correctly rounded, cached until a statistic
    changes and unchanged by a bfloat16 cast."""
    from rdpn6d_tpu_torch.models.norm import rsqrt_f32

    bn = BatchNorm2d(8)
    with torch.no_grad():
        bn.running_var.copy_(torch.linspace(0.1, 4.0, 8))
        bn.weight.copy_(torch.linspace(-2.0, 2.0, 8))
    mean, mul, bias = bn.folded()
    var = (bn.running_var + 1e-5).numpy()
    want = torch.from_numpy(rsqrt_f32(var)) * bn.weight.detach()
    assert torch.equal(mul, want) and mul.dtype == torch.float32
    assert bn.folded()[1] is mul                  # cached
    assert torch.equal(bn.to(torch.bfloat16).folded()[1], mul)
    with torch.no_grad():
        bn.running_var.mul_(4.0)
    var = (bn.running_var + 1e-5).numpy()
    assert torch.equal(bn.folded()[1], torch.from_numpy(rsqrt_f32(var))
                       * bn.weight.detach())


def test_rsqrt_f32_is_correctly_rounded():
    """``rsqrt_f32`` gives the float32 nearest 1 / sqrt(v), held against
    exact rationals (the true value lies between the midpoints to the
    result's neighbours), on seeded variances over many binades and at
    powers of two, where the result is exact."""
    from rdpn6d_tpu_torch.models.norm import rsqrt_f32

    rng = np.random.RandomState(7)
    v = np.concatenate([
        np.exp(rng.uniform(np.log(1e-6), np.log(1e6), 3000)),
        2.0 ** np.arange(-20, 21)]).astype(np.float32)
    r = rsqrt_f32(v)
    assert r.dtype == np.float32 and r.shape == v.shape
    for x, y in zip(v.tolist(), r):
        lo = np.nextafter(y, np.float32(0))
        hi = np.nextafter(y, np.float32(np.inf))
        assert ((Fraction(float(lo)) + Fraction(float(y))) / 2) ** 2 \
            * Fraction(x) < 1
        assert ((Fraction(float(y)) + Fraction(float(hi))) / 2) ** 2 \
            * Fraction(x) > 1
    even = 2.0 ** np.arange(-20, 21, 2)
    assert np.array_equal(rsqrt_f32(even.astype(np.float32)),
                          (1.0 / np.sqrt(even)).astype(np.float32))


def test_head_bf16_cast_keeps_its_norms_float32():
    head = DenseHead(16, num_filters=8, num_layers=1, int8=True,
                     int8_static=True).to(torch.bfloat16)
    bns = [m for m in head.modules() if isinstance(m, BatchNorm2d)]
    assert len(bns) == 3
    assert all(b.weight.dtype == torch.float32
               and b.running_var.dtype == torch.float32 for b in bns)
