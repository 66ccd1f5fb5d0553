"""int8 serving: the port's ``Int8Conv``, ``calibrate_quant``, int8
``RDPN``, ``Predictor`` and ``run_eval`` against the JAX package's
(``rdpn6d_tpu.models.quant`` and its callers), on the CPU at tiny widths.

Tolerances:
- one ``Int8Conv``: xq, wq, both scales and the output bit-equal
  (tolerance 0): both sides round every float op in float32 in the same
  order, and the int32 sum is exact on both;
- the whole model, ``Predictor`` and ``run_eval`` with each int8 conv fed
  JAX's own input to that conv ("carried", as the calibrated scales are;
  a head conv that folds the BN, ReLU and concat before it is fed JAX's
  input to that BN, JAX's folded multiplier rsqrt(var + eps) * scale and
  JAX's skip channels, so that the fused quantizer is held to XLA's BN;
  a calibration pass, which the JAX package runs op by op, is fed JAX's
  conv input): every int8 conv's output bit-equal (to JAX's conv applied
  op by op to the same input); logits within 1e-4; poses within 1e-3
  (rotation entries; translation relative to its norm), ``run_eval``'s
  CSV within 1e-4 as ``tests/test_torch_eval_runner.py``. Free-running,
  each side on its own activations, the inputs of the first int8 conv
  differ by float32 sums in other orders, so a few land on the other side
  of a rounding boundary of the quantizer; each such flip moves the next
  convs' inputs by a quantization step and the flips multiply from conv
  to conv. Those runs are printed (flips per conv, pose and logit
  differences), and only the first conv's flips are gated (<= 1e-3);
- calibrated absmax of the whole model within 1e-5 of the conv's largest
  absmax (a max of activations that differ by float32 sums; for a scalar
  absmax that is 1e-5 relative).
"""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.experimental import io_callback

import rdpn6d_tpu.data.refs as jrefs
import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.data.assets import synthetic_class_assets as j_assets
from rdpn6d_tpu.engine.eval_runner import run_eval as j_run_eval
from rdpn6d_tpu.engine.predictor import Detection as JDet
from rdpn6d_tpu.engine.predictor import Predictor as JPredictor
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.models import dummy_batch
from rdpn6d_tpu.models.quant import Int8Conv as JInt8Conv
from rdpn6d_tpu.models.quant import calibrate_quant as j_calibrate
from rdpn6d_tpu.models.quant import quantize_symmetric as j_qsym
from rdpn6d_tpu.parallel import create_train_state as j_train_state
from rdpn6d_tpu.solver import build_optimizer as j_build_optimizer
from rdpn6d_tpu_torch import main as tmain
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data import assets as tassets
from rdpn6d_tpu_torch.engine.checkpoint import CheckpointManager
from rdpn6d_tpu_torch.engine.eval_runner import run_eval as t_run_eval
from rdpn6d_tpu_torch.engine.predictor import Detection as TDet
from rdpn6d_tpu_torch.engine.predictor import Predictor as TPredictor
from rdpn6d_tpu_torch.models import RDPN as TRDPN
from rdpn6d_tpu_torch.models import init_weights
from rdpn6d_tpu_torch.models.quant import Int8Conv, calibrate_quant
from rdpn6d_tpu_torch.ops import cuda_build
from rdpn6d_tpu_torch.ops.int8_conv import (
    bn_relu_quantize,
    int8_conv,
    quantize_act,
    quantize_symmetric,
)
from rdpn6d_tpu_torch.parallel import create_train_state
from rdpn6d_tpu_torch.utils.flax_params import (
    conv_paths,
    load_quant,
    quant_tree,
    state_dict_from_flax,
)
from tests.test_torch_eval_runner import OPTS as EVAL_OPTS
from tests.test_torch_eval_runner import _read_csv, tree, weights  # noqa
from tests.test_torch_model import TINY, make_batch, perturb

OPTS = TINY + ["backbone.rot_concat=true"]
K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
BOXES = [[200, 150, 330, 280.0], [300, 200, 420, 320.0],
         [5, 400, 120, 478.0], [560, 10, 640, 60.0]]
MODES = ["head", "trunk", "all", True, "trunk0", "trunk1", "trunk2",
         "trunk3"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jmodel():
    """Seeded, perturbed tiny float32 flax variables and a pickle of them."""
    cfg = JConfig().apply_opts(OPTS)
    variables = jax.jit(lambda k: JRDPN(cfg, dtype=jnp.float32).init(
        k, dummy_batch(cfg, 1), train=False))(jax.random.PRNGKey(3))
    params, stats = perturb(variables, 3)
    return params, stats


@pytest.fixture(scope="module")
def pkl(jmodel, tmp_path_factory):
    params, stats = jmodel
    path = str(tmp_path_factory.mktemp("w") / "params.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": params, "batch_stats": stats}, f)
    return path


# ----------------------------------------------------------- one Int8Conv

def _jax_quantized(x, kernel, static, amax):
    """xq, sx, wq, sw as the JAX package's Int8Conv computes them
    (quant.py:113-145), NHWC / HWIO."""
    if static == "per_channel":
        wmax = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 3)), 1e-12)
        t = jnp.sqrt(jnp.maximum(amax, 1e-12) / wmax)
        s = jnp.maximum(jnp.max(amax / t), 1e-12) / 127.0
        xq = jnp.clip(jnp.round(x / (t * s)), -127, 127).astype(jnp.int8)
        wq, sw = j_qsym(kernel * t[None, None, :, None], axis=(0, 1, 2))
        sx = jnp.full((x.shape[0],), s)
    else:
        wq, sw = j_qsym(kernel, axis=(0, 1, 2))
        if static:
            s = jnp.maximum(amax, 1e-12) / 127.0
            xq = jnp.clip(jnp.round(x / s), -127, 127).astype(jnp.int8)
            sx = jnp.full((x.shape[0],), s)
        else:
            xq, sx = j_qsym(x, axis=(1, 2, 3))
    return [np.asarray(v) for v in (xq, jnp.ravel(sx), wq, jnp.ravel(sw))]


@pytest.mark.parametrize("static", [False, True, "per_channel"])
@pytest.mark.parametrize("k,stride,pad,cin", [
    (3, 1, 1, 40), (3, 2, 1, 32), (1, 2, 0, 16), (1, 1, 0, 8)])
def test_int8_conv_bit_equal_to_jax(static, k, stride, pad, cin):
    rng = np.random.RandomState(cin * k + stride)
    # channels of unlike ranges, post-ReLU-like, an odd spatial size
    x = np.maximum(rng.randn(2, 9, 10, cin) * rng.uniform(0.1, 3, cin),
                   -0.5).astype(np.float32)
    kernel = (rng.randn(k, k, cin, 24) * 0.1).astype(np.float32)
    jm = JInt8Conv(24, (k, k), strides=(stride, stride),
                   padding=pad if k == 3 else "SAME", dtype=jnp.float32,
                   static_act=static)
    v = {"params": {"kernel": kernel}}
    amax = None
    if static:
        _, mut = jm.apply(v, x, mutable=["quant"])
        v["quant"] = mut["quant"]
        amax = v["quant"]["act_amax"]
    y_j = np.asarray(jm.apply(v, x))

    tm = Int8Conv(cin, 24, k, stride, pad, static)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    if static:
        got = calibrate_quant(tm, [xt])
        np.testing.assert_array_equal(got[""].numpy(), np.asarray(amax))
    with torch.no_grad():
        y_t = tm(xt).numpy().transpose(0, 2, 3, 1)
        wq, sw, a, t = tm.quantized()
        mode = "per_channel" if static == "per_channel" else \
            "static" if static else "dynamic"
        xq, sx = quantize_act(xt, mode, a, t)
    xq_j, sx_j, wq_j, sw_j = _jax_quantized(x, kernel, static, amax)
    np.testing.assert_array_equal(xq[..., :cin].numpy(), xq_j)
    assert not xq[..., cin:].any()
    np.testing.assert_array_equal(sx.numpy(), sx_j)
    np.testing.assert_array_equal(
        wq[..., :cin].numpy(), wq_j.transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(sw.numpy(), sw_j)
    assert y_t.shape == y_j.shape
    np.testing.assert_array_equal(y_t, y_j)


@pytest.mark.parametrize("static", [False, True, "per_channel"])
def test_int8_conv_nan_matches_jax(static):
    """A NaN in sample 0 after calibration on clean input: the dynamic
    scale, and so that sample's whole output, is NaN; a NaN quantizes to 0
    (XLA's conversion), so the static modes serve finite outputs. xq, sx
    and the output equal JAX's, NaN for NaN; sample 1 is untouched."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 6, 7, 40).astype(np.float32)
    kernel = (rng.randn(3, 3, 40, 24) * 0.1).astype(np.float32)
    jm = JInt8Conv(24, (3, 3), padding=1, dtype=jnp.float32,
                   static_act=static)
    v = {"params": {"kernel": kernel}}
    amax = None
    if static:
        _, mut = jm.apply(v, x, mutable=["quant"])
        v["quant"] = mut["quant"]
        amax = v["quant"]["act_amax"]
    xn = x.copy()
    xn[0, 2, 3, 5] = np.nan
    xn[0, 4, 1, 30] = -np.nan
    y_j = np.asarray(jm.apply(v, xn))

    tm = Int8Conv(40, 24, 3, 1, 1, static)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    if static:
        calibrate_quant(tm, [torch.from_numpy(x.transpose(0, 3, 1, 2).copy())])
    xt = torch.from_numpy(xn.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        y_t = tm(xt).numpy().transpose(0, 2, 3, 1)
        _, _, a, t = tm.quantized()
        mode = "per_channel" if static == "per_channel" else \
            "static" if static else "dynamic"
        xq, sx = quantize_act(xt, mode, a, t)
    xq_j, sx_j, _, _ = _jax_quantized(xn, kernel, static, amax)
    np.testing.assert_array_equal(xq[..., :40].numpy(), xq_j)
    assert xq[0, 2, 3, 5] == 0 and xq[0, 4, 1, 30] == 0
    np.testing.assert_array_equal(sx.numpy(), sx_j)
    np.testing.assert_array_equal(y_t, y_j)
    assert np.isfinite(y_t[1]).all()
    if static:
        assert np.isfinite(y_t).all()
    else:
        assert np.isnan(sx[0].item()) and np.isnan(y_t[0]).all()


def test_quantize_symmetric_matches_jax():
    x = np.random.RandomState(0).randn(64, 32).astype(np.float32)
    for dim, axis in ((None, None), ((1,), (1,))):
        q, s = quantize_symmetric(torch.from_numpy(x), dim)
        qj, sj = j_qsym(jnp.asarray(x), axis)
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(s.numpy().ravel(),
                                      np.asarray(sj).ravel())


def test_cpu_tensors_never_launch():
    before = dict(cuda_build.LAUNCHES)
    x = torch.randn(2, 8, 5, 5)
    xq, sx = quantize_act(x, "dynamic")
    wq = torch.zeros(4, 3, 3, 32, dtype=torch.int8)
    out = int8_conv(xq, sx, wq, torch.ones(4), 1, 1, torch.float32)
    assert out.shape == (2, 4, 5, 5)
    assert dict(cuda_build.LAUNCHES) == before


# ------------------------------------------------- calibration, validation

def test_calibrate_quant_refusals():
    conv = Int8Conv(8, 4, 3, 1, 1, static_act=True)
    with pytest.raises(ValueError, match="empty"):
        calibrate_quant(conv, [])
    with pytest.raises(ValueError, match="int8 enabled"):
        calibrate_quant(Int8Conv(8, 4, 3, 1, 1), [torch.ones(1, 8, 4, 4)])
    with pytest.raises(ValueError, match="ZERO"):
        calibrate_quant(conv, [torch.zeros(1, 8, 4, 4)])
    # a per-channel absmax may hold dead channels, not only zeros
    pc = Int8Conv(8, 4, 3, 1, 1, static_act="per_channel")
    x = torch.zeros(1, 8, 4, 4)
    x[:, 3] = 1.0
    got = calibrate_quant(pc, [x])
    assert got[""].tolist() == [0, 0, 0, 1, 0, 0, 0, 0]


@pytest.mark.parametrize("bad", ["trunk5", "foo", "True", "trunk", "head"])
def test_int8_mode_validation_matches_jax(bad):
    """Unknown modes raise ValueError in both packages; the good ones
    ("trunk", "head") build."""
    good = bad in ("trunk", "head")
    jcfg = JConfig().apply_opts(OPTS)
    b = dummy_batch(jcfg, 1)

    def jax_init():
        jax.eval_shape(lambda: JRDPN(jcfg, dtype=jnp.float32, int8=bad)
                       .init(jax.random.PRNGKey(0), b, train=False))

    if good:
        jax_init()
        TRDPN(TConfig().apply_opts(OPTS), int8=bad)
        return
    with pytest.raises(ValueError):
        jax_init()
    with pytest.raises(ValueError):
        TRDPN(TConfig().apply_opts(OPTS), int8=bad)


def test_int8_static_without_int8_serves_full_precision():
    cfg = TConfig().apply_opts(OPTS + ["test.int8_static=true"])
    pred = TPredictor(cfg, tassets.synthetic_class_assets(num_regions=4),
                      device="cpu", allow_random_init=True,
                      dtype=torch.float32)
    assert not any(isinstance(m, Int8Conv) for m in pred.model.modules())
    assert not pred._needs_calibration


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("static", [True, "per_channel"])
def test_int8_convs_match_jax_quant_tree(mode, static):
    """Each mode quantizes the convs the JAX package quantizes: the port's
    static Int8Conv set, by flax path, is JAX's ``quant`` collection, with
    the same absmax shapes (the stem and the head's output conv stay
    float)."""
    jcfg = JConfig().apply_opts(OPTS)
    shapes = jax.eval_shape(lambda: JRDPN(
        jcfg, dtype=jnp.float32, int8=mode, int8_static=static).init(
        jax.random.PRNGKey(0), dummy_batch(jcfg, 1), train=False))

    def leaves(t, pre=()):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, pre + (k,))
            else:
                yield pre + (k,), tuple(v.shape)

    want = dict(leaves(shapes["quant"]))
    tm = TRDPN(TConfig().apply_opts(OPTS), int8=mode, int8_static=static)
    got = dict(leaves(quant_tree(tm)))
    assert got == want
    n8 = sum(isinstance(m, Int8Conv) for m in tm.modules())
    assert n8 == len(want)
    paths = conv_paths(tm.cfg)
    assert not isinstance(tm.backbone.conv1, Int8Conv)
    assert "backbone.conv1" in paths


# ------------------------------------------------------------ whole model

def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


class _JaxBN:
    """A port BatchNorm2d's folded constants with JAX's multiplier."""

    def __init__(self, bn, mul):
        mean, _, bias = bn.folded()
        self._folded = (mean, torch.from_numpy(np.asarray(mul)).to(
            mean.device), bias)

    def folded(self):
        return self._folded


class _Carry:
    """Records every JAX Int8Conv call in call order (calibration passes
    included; under jit by ordered ``io_callback``s): its input, its output
    and the input and multiplier rsqrt(var + eps) * scale of the BatchNorm
    called last before it; under jit each BN and Int8Conv input goes
    through the host (``through_host``), so that the module reads the
    value recorded. ``attach`` feeds them in the same order to a
    port model's Int8Convs (``_carried``), cut to the port's batch (the
    JAX package pads a batch by repeating its last ROI; the port does
    not)."""

    def __init__(self):
        self.calls: list[dict] = []
        self.used = 0
        self._bn = self._x = None

    def run_jax(self, fn):
        def keep_bn(x, mul):
            self._bn = (np.asarray(x), np.asarray(mul))

        def keep_input(x):
            self._x = np.asarray(x)

        def keep_conv(y, variables, mod):
            self.calls.append({"x": self._x, "y": np.asarray(y),
                               "bn": self._bn, "module": mod,
                               "variables": jax.device_get(variables)})

        def through_host(keep, x, *more):
            """x, after ``keep(x, *more)`` on the host: under jit XLA
            must materialize x to pass it, and the reader takes what was
            recorded. Without that, XLA fuses an int8 conv's dequantizing
            product into the next BN's fusion, whose outputs then match
            no carried input (1 ulp off in ~10%), optimization barrier or
            not."""
            if not isinstance(x, jax.core.Tracer):
                keep(x, *more)
                return x

            def f(x, *more):
                keep(x, *more)
                return np.asarray(x)
            # one ordered effect for every record: their order holds
            return io_callback(f, jax.ShapeDtypeStruct(x.shape, x.dtype),
                               x, *more, ordered=True)

        def grab(next_fun, args, kwargs, context):
            mod = context.module
            if context.method_name != "__call__":
                return next_fun(*args, **kwargs)
            if isinstance(mod, fnn.BatchNorm):
                mul = jax.lax.rsqrt(mod.get_variable("batch_stats", "var")
                                    + mod.epsilon) \
                    * mod.get_variable("params", "scale")
                args = (through_host(keep_bn, args[0], mul),) + args[1:]
            elif isinstance(mod, JInt8Conv):
                args = (through_host(keep_input, args[0]),) + args[1:]
            out = next_fun(*args, **kwargs)
            if isinstance(mod, JInt8Conv):
                variables = {"params": {
                    "kernel": mod.get_variable("params", "kernel")}}
                if mod.static_act:
                    variables["quant"] = {"act_amax": mod.get_variable(
                        "quant", "act_amax")}
                out = through_host(functools.partial(
                    keep_conv, mod=mod.clone(parent=None)), out, variables)
            return out

        with fnn.intercept_methods(grab):
            out = fn()
        jax.effects_barrier()
        return out

    def attach(self, model):
        """Hooks feeding JAX's calls to ``model``'s Int8Convs; each served
        call's output is kept in ``self.outputs`` beside its JAX call."""
        self.outputs = []

        def pre(mod, args):
            call = self.calls[self.used]
            self.used += 1
            return _carried(mod, call, args)

        def post(mod, args, out):
            if not mod.calibrating:
                self.outputs.append((self.calls[self.used - 1], out))

        convs = [m for m in model.modules() if isinstance(m, Int8Conv)]
        return [m.register_forward_pre_hook(pre) for m in convs] \
            + [m.register_forward_hook(post) for m in convs]

    def assert_outputs_equal(self):
        """Every served int8 conv's output equals JAX's op by op on the
        same input, bit for bit."""
        assert self.outputs
        for call, out in self.outputs:
            want = _jax_op_by_op(call)[:out.shape[0]]
            np.testing.assert_array_equal(out.numpy(),
                                          want.transpose(0, 3, 1, 2))


def _jax_op_by_op(call):
    """The JAX Int8Conv of ``call`` applied op by op (not under jit) to its
    recorded input: the reference of an int8 conv's output. Under jit XLA
    fuses the dequantizing product acc * (sx * sw) into its program, and
    up to ~10% of a conv's outputs come out 1 ulp otherwise at these
    widths."""
    return np.asarray(call["module"].apply(call["variables"], call["x"]))


def _carried(mod, call, args):
    """What a port Int8Conv called with ``args`` takes from the JAX call
    ``call``: JAX's conv input; where the port folds the BN before the
    conv, JAX's input to that BN, its multiplier and JAX's skip channels
    (the rest of the conv's input). A calibration pass takes JAX's conv
    input either way: the JAX package calibrates op by op, where its BN
    rounds the product and the sum apart."""
    x = args[0]
    n, c1 = x.shape[0], x.shape[1]
    if len(args) < 2 or args[1] is None or mod.calibrating:
        xj = call["x"]
        skip = args[2] if len(args) > 2 else None
        assert xj.shape[0] >= n and xj.shape[1:3] == tuple(x.shape[2:]) \
            and xj.shape[3] == c1 + (0 if skip is None else skip.shape[1])
        return (_nchw(xj[:n]).to(x.dtype),)
    yj, mul = call["bn"]
    skip = args[2]
    assert yj.shape[0] >= n and yj.shape[1:] == tuple(
        x.permute(0, 2, 3, 1).shape[1:])
    assert call["x"].shape[3] == c1 + (0 if skip is None else skip.shape[1])
    sj = None if skip is None else _nchw(call["x"][:n, ..., c1:]).to(x.dtype)
    return (_nchw(yj[:n]).to(x.dtype), _JaxBN(args[1], mul), sj)


def _run(tm, tb, carry=None):
    """The port model's outputs, its Int8Convs and, in call order, each
    Int8Conv call's module and arguments; with ``carry`` (a ``_Carry``
    that ran the JAX model) every call takes JAX's (``_carried``)."""
    convs = [m for m in tm.modules() if isinstance(m, Int8Conv)]
    calls = []

    def pre(mod, args):
        if carry is not None:
            args = _carried(mod, carry.calls[len(calls)], args)
        calls.append((mod, args))
        return args

    hooks = [m.register_forward_pre_hook(pre) for m in convs]
    try:
        with torch.no_grad():
            out = tm(tb)
    finally:
        for h in hooks:
            h.remove()
    return out, convs, calls


def _quantized_input(args, mode, amax, t):
    """xq of the input an Int8Conv call with ``args`` quantizes."""
    if len(args) > 1 and args[1] is not None:
        return bn_relu_quantize(args[0], *args[1].folded(), mode, amax, t,
                                args[2])
    return quantize_act(args[0], mode, amax, t)


def _assert_outputs_close(out, ref):
    for k in ("mask_logits", "coord_out", "region_logits"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(out["rot_ego"].numpy(),
                               np.asarray(ref["rot_ego"]), atol=1e-3)
    tj = np.asarray(ref["trans"])
    np.testing.assert_allclose(out["trans"].numpy(), tj, rtol=0,
                               atol=1e-3 * np.abs(tj).max())


def _leaves(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, pre + (k,))
        else:
            yield pre + (k,), np.asarray(v)


def _model_matches_jax(jmodel, int8, static):
    """The int8 model in float32 against JAX's on one batch: the port's own
    calibrated absmax; then, with JAX's scales and each int8 conv's input
    carried, every int8 conv's output bit-equal and the outputs close;
    free-running, the first int8 conv's flips gated; the quant tree goes
    back unchanged."""
    params, stats = jmodel
    jcfg = JConfig().apply_opts(OPTS)
    jm = JRDPN(jcfg, dtype=jnp.float32, int8=int8, int8_static=static)
    batch = make_batch(jcfg, B=2, seed=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    quant = j_calibrate(jm, params, stats, [jb])
    carry = _Carry()
    ref = carry.run_jax(lambda: jax.jit(
        lambda v, b: jm.apply(v, b, train=False))(
        {"params": params, "batch_stats": stats, "quant": quant}, jb))

    tcfg = TConfig().apply_opts(OPTS)
    tm = TRDPN(tcfg, int8=int8, int8_static=static)
    tm.load_state_dict(state_dict_from_flax(tcfg, params, stats))
    tm.eval()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    # the port's own calibration on the same batch
    own = calibrate_quant(tm, [tb])
    assert len(own) == len(dict(_leaves(quant)))
    for name, v in own.items():
        node = quant
        for k in conv_paths(tcfg)[name]:
            node = node[k]
        j = np.asarray(node["act_amax"])
        np.testing.assert_allclose(v.numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max(), err_msg=name)
    # serve with JAX's scales, carried through the flax tree, and JAX's
    # input to every int8 conv: each conv's output is JAX's bit for bit,
    # and the rest of the model agrees as the float model does
    load_quant(tm, jax.device_get(quant))
    out, convs, calls = _run(tm, tb, carry=carry)
    assert len(convs) == len(calls) == len(carry.calls) == len(own)
    with torch.no_grad():
        for (m, args), call in zip(calls, carry.calls):
            np.testing.assert_array_equal(
                m(*args).numpy(), _jax_op_by_op(call).transpose(0, 3, 1, 2))
    _assert_outputs_close(out, ref)
    # free-running, each side on its own activations: at the first int8
    # conv they differ by float32 sums alone, so few activations land on
    # the other side of a rounding boundary; each such flip moves the
    # next convs' inputs by a quantization step, so later convs flip more
    free, _, t_calls = _run(tm, tb)
    mode = "per_channel" if static == "per_channel" else "static"
    flips = []
    for (m, args), call in zip(t_calls, carry.calls):
        _, _, amax, t = m.quantized()
        q_t, _ = _quantized_input(args, mode, amax, t)
        q_j, _ = quantize_act(_nchw(call["x"]), mode, amax, t)
        flips.append((int((q_t != q_j).sum()),
                      q_j[..., :m.in_channels].numel()))
    dlog = max(float(np.abs(free[k].numpy() - np.asarray(ref[k])).max())
               for k in ("mask_logits", "coord_out", "region_logits"))
    print(f"int8 {int8} static={static}, free-running: flipped activations "
          f"conv by conv (of n) {flips}; max |logit diff| {dlog:.3e}")
    assert flips[0][0] <= 1e-3 * flips[0][1]
    # ... and the tree goes back unchanged
    back = dict(_leaves(quant_tree(tm)))
    want = dict(_leaves(jax.device_get(quant)))
    assert back.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=str(path))
    return convs


def test_int8_head_static_model_matches_jax(jmodel):
    convs = _model_matches_jax(jmodel, "head", True)
    assert len(convs) == 2 * TConfig().apply_opts(OPTS).head.num_layers


@pytest.mark.parametrize("static", [True, "per_channel"])
def test_int8_all_model_matches_jax(jmodel, static):
    """Every trunk block's convs (1x1 stride-2 downsamples included) and
    the head's, with a static scalar or per-channel SmoothQuant scales."""
    convs = _model_matches_jax(jmodel, "all", static)
    assert any(m.stride[0] == 2 and m.kernel_size[0] == 1 for m in convs)
    assert all(m.per_channel == (static == "per_channel") for m in convs)


def _frames():
    rng = np.random.RandomState(0)
    rgb = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    depth = (0.8 + 0.1 * rng.rand(480, 640)).astype(np.float32)
    return rgb, depth


def _assert_poses_close(t_out, j_out, tol):
    assert len(t_out) == len(j_out)
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a["R"], b["R"], rtol=0, atol=tol)
        np.testing.assert_allclose(a["t"], b["t"], rtol=0,
                                   atol=tol * np.abs(b["t"]).max())


@pytest.mark.parametrize("static", [True, False])
def test_int8_predictor_matches_jax(pkl, static):
    """Both Predictors serve 4 boxes in batches of 2 with the int8 head
    (the batch of the other tests here: JAX's eager calibration compiles
    once); static calibrates on the first batch. Each int8
    conv takes JAX's input (the calibration pass's too), so the int8
    convs agree bit for bit and the poses within 1e-3 (a region argmax
    downstream of them may still tip)."""
    opts = OPTS + ['test.int8="head"', f"test.int8_static={str(static)}"]
    rgb, depth = _frames()
    carry = _Carry()
    jp = JPredictor(JConfig().apply_opts(opts), j_assets(num_regions=4),
                    params_pkl=pkl, batch_size=2, dtype=jnp.float32)
    j_out = carry.run_jax(lambda: jp.predict(
        rgb, depth, K, [JDet(1, np.array(b)) for b in BOXES]))
    tp = TPredictor(TConfig().apply_opts(opts),
                    tassets.synthetic_class_assets(num_regions=4),
                    params_pkl=pkl, batch_size=2, dtype=torch.float32,
                    device="cpu")
    assert tp._needs_calibration == static
    dets = [TDet(1, np.array(b)) for b in BOXES]
    free = tp.predict(rgb, depth, K, dets)
    hooks = carry.attach(tp.model)
    tp._needs_calibration = static           # calibrate again, carried
    t_out = tp.predict(rgb, depth, K, dets)
    for h in hooks:
        h.remove()
    assert not tp._needs_calibration
    n8 = sum(isinstance(m, Int8Conv) for m in tp.model.modules())
    assert n8 == 2 * tp.cfg.head.num_layers
    # calibration (static) and 2 served batches, each through every conv
    assert carry.used == len(carry.calls) == n8 * (2 + static)
    carry.assert_outputs_equal()
    _assert_poses_close(t_out, j_out, 1e-3)
    dR = max(float(np.abs(a["R"] - b["R"]).max()) for a, b in zip(free,
                                                                  j_out))
    print(f"int8 head Predictor, static={static}, free-running: max |dR| "
          f"{dR:.3e}")


def test_bf16_predictor_quantizes_from_float32_weights(jmodel, pkl):
    """Trap: ``model.to(bfloat16)`` would round the weights and the
    scales. Int8Conv keeps its weight and absmax in float32, so its wq and
    sw are those of the float32 checkpoint."""
    params, _ = jmodel
    cfg = TConfig().apply_opts(OPTS + ['test.int8="all"',
                                       "test.int8_static=true"])
    tp = TPredictor(cfg, tassets.synthetic_class_assets(num_regions=4),
                    params_pkl=pkl, dtype=torch.bfloat16, device="cpu")
    assert tp.model.dtype == torch.bfloat16
    paths = conv_paths(cfg)
    n = 0
    for name, m in tp.model.named_modules():
        if not isinstance(m, Int8Conv):
            continue
        assert m.weight.dtype == torch.float32
        assert m.act_amax.dtype == torch.float32
        node = params
        for k in paths[name]:
            node = node[k]
        kernel = np.asarray(node["kernel"])
        np.testing.assert_array_equal(m.weight.detach().numpy(),
                                      kernel.transpose(3, 2, 0, 1))
        wq, sw, _, _ = m.quantized()
        wq_j, sw_j = j_qsym(jnp.asarray(kernel), axis=(0, 1, 2))
        np.testing.assert_array_equal(
            wq[..., :kernel.shape[2]].numpy(),
            np.asarray(wq_j).transpose(3, 0, 1, 2))
        np.testing.assert_array_equal(sw.numpy(), np.asarray(sw_j).ravel())
        n += 1
    assert n > 0
    rgb, depth = _frames()
    out = tp.predict(rgb, depth, K, [TDet(1, np.array(b)) for b in BOXES])
    assert all(np.isfinite(o["R"]).all() and np.isfinite(o["t"]).all()
               for o in out)
    # the served batch calibrated float32 scales
    assert all(float(m.act_amax.abs().max()) > 0
               for m in tp.model.modules() if isinstance(m, Int8Conv))


# ------------------------------------------------------------------ eval

@pytest.mark.parametrize("static", [True, False])
def test_int8_run_eval_matches_jax(tree, weights, tmp_path, monkeypatch,  # noqa
                                   static):
    """Both runners on the same tree and weights with the int8 head; each
    int8 conv takes JAX's input, calibration included (as in the
    Predictor test)."""
    monkeypatch.setattr(jrefs, "DATA_ROOT", tree)
    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    params, stats, ckpt = weights
    opts = EVAL_OPTS + ['test.int8="head"', f"test.int8_static={static}",
                        f'train.output_dir="{tmp_path}"']
    jcfg = JConfig().apply_opts(opts)
    state = j_train_state(jcfg, {"params": params, "batch_stats": stats},
                          j_build_optimizer(jcfg, total_iters=1))
    carry = _Carry()
    j = carry.run_jax(lambda: j_run_eval(
        jcfg, ckpt_dir="", split_name="two_obj_test", batch_size=2,
        state=state, model=JRDPN(jcfg, dtype=jnp.float32, int8="head",
                                 int8_static=static),
        csv_path=str(tmp_path / "jax.csv")))
    from rdpn6d_tpu_torch.engine import eval_runner

    real = eval_runner._load_model

    def load_and_carry(*a, **kw):
        model = real(*a, **kw)
        carry.attach(model)
        return model

    monkeypatch.setattr(eval_runner, "_load_model", load_and_carry)
    t = t_run_eval(TConfig().apply_opts(opts), ckpt_dir=ckpt,
                   split_name="two_obj_test", batch_size=2,
                   csv_path=str(tmp_path / "port.csv"),
                   dtype=torch.float32, device="cpu")
    assert carry.used == len(carry.calls) == 6 * (3 + static)
    carry.assert_outputs_equal()
    j_id, j_R, j_t = _read_csv(tmp_path / "jax.csv")
    t_id, t_R, t_t = _read_csv(tmp_path / "port.csv")
    assert t_id == j_id
    np.testing.assert_allclose(t_R, j_R, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_t, j_t, rtol=1e-4, atol=0)
    assert t["stats"]["n_rois"] == j["stats"]["n_rois"] == 6
    assert t["per_obj"] == j["per_obj"]


def test_int8_eval_of_live_model_uses_serving_copy(tree, tmp_path,  # noqa
                                                   monkeypatch):
    """Eval during training under int8: the live float32 model is served
    through an int8 copy with its current weights, gives what a checkpoint
    of the same weights gives, and comes back untouched, in train mode."""
    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    cfg = TConfig().apply_opts(EVAL_OPTS + [
        'test.int8="head"', "test.int8_static=true",
        f'train.output_dir="{tmp_path}"'])
    live = init_weights(TRDPN(cfg), torch.Generator().manual_seed(2))
    live.train()
    before = {k: v.clone() for k, v in live.state_dict().items()}
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).save(1, create_train_state(cfg, live))
    a = t_run_eval(cfg, ckpt_dir="", split_name="two_obj_test",
                   batch_size=2, csv_path=str(tmp_path / "live.csv"),
                   dtype=torch.float32, model=live)
    b = t_run_eval(cfg, ckpt_dir=ckpt, split_name="two_obj_test",
                   batch_size=2, csv_path=str(tmp_path / "ckpt.csv"),
                   dtype=torch.float32, device="cpu")
    assert live.training
    assert not any(isinstance(m, Int8Conv) for m in live.modules())
    for k, v in live.state_dict().items():
        assert torch.equal(v, before[k]), k
    _, R_a, t_a = _read_csv(tmp_path / "live.csv")
    _, R_b, t_b = _read_csv(tmp_path / "ckpt.csv")
    np.testing.assert_array_equal(R_a, R_b)
    np.testing.assert_array_equal(t_a, t_b)
    assert a["per_obj"] == b["per_obj"]
    # a second period serves the new weights
    with torch.no_grad():
        live.rot_head_net.features[3].weight.mul_(1.5)
    t_run_eval(cfg, ckpt_dir="", split_name="two_obj_test", batch_size=2,
               csv_path=str(tmp_path / "live2.csv"), dtype=torch.float32,
               model=live)
    _, R_c, _ = _read_csv(tmp_path / "live2.csv")
    assert not np.array_equal(R_c, R_a)


def test_main_eval_only_int8_reaches_runner(tree, weights, tmp_path,  # noqa
                                            monkeypatch):
    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    _, _, ckpt = weights
    out = tmp_path / "run"
    os.makedirs(out)
    os.symlink(ckpt, out / "ckpt")
    seen = []
    from rdpn6d_tpu_torch.models import quant as tquant

    real = tquant.calibrate_quant

    def spy(model, batches):
        seen.append(sum(isinstance(m, Int8Conv) for m in model.modules()))
        return real(model, batches)

    monkeypatch.setattr(tquant, "calibrate_quant", spy)
    res = tmain.main([
        "--config-file", "rdpn6d_tpu_torch/configs/lm13.py", "--eval-only",
        "--device", "cpu", "--opts", *EVAL_OPTS, f'train.output_dir="{out}"',
        'data.test_datasets=["two_obj_test"]', 'test.int8="head"',
        "test.int8_static=true"])
    assert res["two_obj_test"]["stats"]["n_rois"] == 6
    assert seen == [6]                     # 2 x num_layers head convs
    assert "int8 static scales calibrated" in (out / "log.txt").read_text()
