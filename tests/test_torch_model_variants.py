"""The serving-side model variants against the JAX package: the
space-to-depth stem (``backbone.space_to_depth``), ``TransHead``
(``pnp.r_only``), and the point PnP heads ``SimplePointPnP`` and
``PointPnP`` (``pnp.pnp_head``), with the flax weights carried over by
``utils/flax_params``.

Tolerances: a head alone on the same input within 1e-5 of its largest
output (float32, sums in other orders); the whole tiny model as
``test_torch_model.py`` holds it (3e-5 of each output's magnitude); the s2d
stem against the 7x7 stem it replaces within 1e-5 (the same products,
summed in another order); one float64 train step's losses within 1e-6 and
``grad_norm`` within 1e-5 relative, as ``test_torch_train_step.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.models.heads import TransHead as JTransHead
from rdpn6d_tpu.models.point_pnp import PointPnP as JPointPnP
from rdpn6d_tpu.models.point_pnp import SimplePointPnP as JSimplePointPnP
from rdpn6d_tpu.models.resnet import space_to_depth as j_space_to_depth
from rdpn6d_tpu.models.resnet import stem_kernel_to_s2d as j_stem_to_s2d
from rdpn6d_tpu.losses import compute_losses as j_losses
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data.synthetic import dummy_train_batch
from rdpn6d_tpu_torch.engine.checkpoint import CheckpointManager
from rdpn6d_tpu_torch.models import RDPN, init_weights
from rdpn6d_tpu_torch.models.heads import TransHead
from rdpn6d_tpu_torch.models.point_pnp import PointPnP, SimplePointPnP
from rdpn6d_tpu_torch.models.resnet import (
    ResNetTrunk,
    space_to_depth,
    stem_kernel_to_s2d,
)
from rdpn6d_tpu_torch.parallel import create_train_state, make_train_step
from rdpn6d_tpu_torch.solver import build_schedule
from rdpn6d_tpu_torch.utils.flax_params import (
    carry,
    point_pnp_state,
    state_dict_from_flax,
    trans_head_state,
)
from rdpn6d_tpu_torch.utils.pretrained import load_pretrained_backbone
from tests.test_torch_model import (
    TINY,
    assert_outputs_match,
    jax_forward,
    perturb,
    torch_forward,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_s2d_stem_equals_the_7x7_stem_and_jax_remap():
    g = torch.Generator().manual_seed(0)
    k7 = torch.randn(64, 3, 7, 7, generator=g) * 0.1
    k4 = stem_kernel_to_s2d(k7)
    # the JAX package's remap of the same kernel, HWIO
    ref = j_stem_to_s2d(k7.permute(2, 3, 1, 0).numpy())
    np.testing.assert_array_equal(k4.permute(2, 3, 1, 0).numpy(), ref)
    x = torch.randn(2, 3, 64, 64, generator=g)
    s2d = space_to_depth(x)
    np.testing.assert_array_equal(
        s2d.permute(0, 2, 3, 1).numpy(),
        np.asarray(j_space_to_depth(jnp.asarray(x.permute(0, 2, 3, 1)
                                                .numpy()))))
    want = F.conv2d(x, k7, stride=2, padding=3)
    got = F.conv2d(F.pad(s2d, (2, 1, 2, 1)), k4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    # the whole trunk: a 7x7 trunk's weights in an s2d trunk
    plain = ResNetTrunk(18).eval()
    s2d_trunk = ResNetTrunk(18, s2d_stem=True).eval()
    sd = plain.state_dict()
    sd["conv1.weight"] = stem_kernel_to_s2d(sd["conv1.weight"])
    s2d_trunk.load_state_dict(sd)
    with torch.no_grad():
        np.testing.assert_allclose(s2d_trunk(x).numpy(), plain(x).numpy(),
                                   atol=1e-5)


def test_s2d_trunk_takes_a_torchvision_stem(tmp_path):
    """A torchvision ResNet file (7x7 stem) loads into an s2d model, its
    stem remapped, as the JAX package's ``load_pretrained_backbone``."""
    cfg = TConfig().apply_opts(TINY + ["backbone.space_to_depth=true"])
    plain = ResNetTrunk(18)
    sd = {k: v for k, v in plain.state_dict().items()}
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd, path)
    model = load_pretrained_backbone(RDPN(cfg), path, depth=18)
    np.testing.assert_array_equal(
        model.backbone.conv1.weight.detach().numpy(),
        stem_kernel_to_s2d(sd["conv1.weight"]).numpy())


VARIANTS = {
    "s2d_stem": ["backbone.space_to_depth=true", "backbone.rot_concat=true"],
    "trans_head": ["pnp.r_only=true"],
    "simple_point_pnp": ['pnp.pnp_head="SimplePointPnP"'],
    # the mask concatenated as a channel (a point head has no slot for it)
    "simple_point_pnp_mask_concat": [
        'pnp.pnp_head="SimplePointPnP"', 'head.mask_loss="BCE"',
        'pnp.mask_attention="concat"'],
    "point_pnp_r_only": ['pnp.pnp_head="PointPnP"',
                         'pnp.mask_attention="mul"', "pnp.r_only=true"],
    # a bare coord assembly, rescaled by the extents in the head
    "point_pnp_bare": ['pnp.pnp_head="PointPnP"',
                       "pnp.with_2d_coord=false"],
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_model_matches_jax(variant):
    opts = TINY + VARIANTS[variant]
    params, stats, batch, ref = jax_forward(opts, B=3)
    ours = torch_forward(opts, params, stats, batch)
    assert_outputs_match(ours, ref)


def _check(ours, ref):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert ours.shape == ref.shape
    assert float(np.abs(ours - ref).max()) <= 1e-5 * scale


def test_trans_head_alone_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 4, 40).astype(np.float32)
    head = JTransHead(num_filters=24, init_mode="fan_in")
    variables = head.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params, stats = perturb(variables, 1)
    ref = head.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(x))
    ours = TransHead(40, num_filters=24, in_res=4)
    ours.load_state_dict(carry(
        lambda w: trans_head_state(w, 3, 24, 4, "", ()), params, stats))
    ours.eval()
    with torch.no_grad():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    _check(got.numpy(), ref)
    # the reference TransHeadNet's names
    assert {k.split(".")[0] for k in ours.state_dict()} == {"features",
                                                            "linears"}


@pytest.mark.parametrize("kind", ["simple", "simple_region", "point",
                                  "point_bare_mul"])
def test_point_heads_alone_match_jax(kind):
    rng = np.random.RandomState(1)
    B, Hh, K = 2, 8, 4
    C = 3 if kind == "point_bare_mul" else 11
    x = rng.rand(B, Hh, Hh, C).astype(np.float32)
    logits = rng.randn(B, Hh, Hh, K).astype(np.float32)
    region = np.array(jax.nn.softmax(logits, -1))
    ext = rng.uniform(0.05, 0.2, (B, 3)).astype(np.float32)
    mask = rng.rand(B, Hh, Hh, 1).astype(np.float32)
    use_region = kind != "simple"
    use_mask = kind == "point_bare_mul"
    if kind.startswith("simple"):
        jhead = JSimplePointPnP(rot_dim=6)
        ours = SimplePointPnP(C + (K if use_region else 0), rot_dim=6)
    else:
        jhead = JPointPnP(rot_dim=6, num_regions=K)
        ours = PointPnP(C, rot_dim=6, num_regions=K)
    kw = {"region": jnp.asarray(region) if use_region else None,
          "extents": jnp.asarray(ext),
          "mask_attention": jnp.asarray(mask) if use_mask else None}
    variables = jhead.init(jax.random.PRNGKey(2), jnp.asarray(x), **kw)
    params, _ = perturb(variables, 2)
    jrot, jt = jhead.apply({"params": params}, jnp.asarray(x), **kw)
    ours.load_state_dict(carry(lambda w: point_pnp_state(w, "", ()), params))

    def nchw(a):
        return None if a is None else torch.from_numpy(a).permute(0, 3, 1, 2)

    with torch.no_grad():
        rot, t = ours(nchw(x), region=nchw(region) if use_region else None,
                      extents=torch.from_numpy(ext),
                      mask_attention=nchw(mask) if use_mask else None)
    _check(rot.numpy(), jrot)
    _check(t.numpy(), jt)
    if kind.startswith("point"):
        with pytest.raises(ValueError, match="region softmax"):
            ours(nchw(x))


def test_point_pnp_r_only_train_step_matches_jax():
    """One float64 train step of a PointPnP + ``pnp.r_only`` model
    (TransHead's translation) from the same flax init on the same batch:
    every loss, the total and ``grad_norm`` against the JAX package's
    losses and gradient at that init (its train step's metrics)."""
    from tests.test_torch_train_step import TINY as STEP_TINY

    opts = STEP_TINY + ['pnp.pnp_head="PointPnP"', "pnp.r_only=true"]
    tcfg = TConfig().apply_opts(opts + ["solver.amp=false"])
    batch = dummy_train_batch(tcfg, 4, seed=0)
    with jax.enable_x64(True):
        jcfg = JConfig().apply_opts(opts)
        model = JRDPN(jcfg, dtype=jnp.float64)
        jb = {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32
                             else v) for k, v in batch.items()}
        variables = jax.jit(lambda key: model.init(key, jb, train=False))(
            jax.random.PRNGKey(0))
        init = jax.tree_util.tree_map(
            lambda v: np.asarray(v, np.float64), jax.device_get(variables))

        def losses(params):
            out, _ = model.apply({"params": params,
                                  "batch_stats": init["batch_stats"]}, jb,
                                 train=True, mutable=["batch_stats"])
            parts = j_losses(jcfg, out, jb)
            return sum(parts.values()), parts

        (total, parts), grads = jax.jit(jax.value_and_grad(
            losses, has_aux=True))(init["params"])
        jm = {k: float(v) for k, v in parts.items()}
        jm["total_loss"] = float(total)
        jm["grad_norm"] = float(optax.global_norm(grads))
    ours = RDPN(tcfg).double()
    ours.load_state_dict(state_dict_from_flax(tcfg, init["params"],
                                              init["batch_stats"]))
    schedule = build_schedule(tcfg, 100)
    st = create_train_state(tcfg, ours, lr=schedule(0))
    _, tm = make_train_step(tcfg, schedule)(
        st, {k: torch.from_numpy(v.astype(np.float64)
                                 if v.dtype == np.float32 else v)
             for k, v in batch.items()})
    assert set(tm) == set(jm)
    for k, v in jm.items():
        tol = 1e-5 if k == "grad_norm" else 1e-6
        assert abs(float(tm[k]) - v) <= tol * max(abs(v), 1e-6), \
            (k, float(tm[k]), v)


@pytest.mark.parametrize("variant", ["s2d_stem", "point_pnp_r_only",
                                     "simple_point_pnp"])
def test_flax_params_round_trip(variant, tmp_path):
    """A JAX tree carried into the port covers its model (strict load),
    survives the port's checkpoint, and a seeded port model's own names
    load back into a fresh model of the config."""
    opts = TINY + VARIANTS[variant]
    cfg = TConfig().apply_opts(opts)
    jcfg = JConfig().apply_opts(opts)
    from rdpn6d_tpu.models import dummy_batch

    variables = jax.jit(lambda key: JRDPN(jcfg, dtype=jnp.float32).init(
        key, dummy_batch(jcfg, 1), train=False))(jax.random.PRNGKey(1))
    params, stats = perturb(variables, 4)
    sd = state_dict_from_flax(cfg, params, stats)
    model = RDPN(cfg)
    model.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.state_dict())
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, create_train_state(cfg, model))
    back = RDPN(cfg)
    mgr.restore(create_train_state(cfg, back))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    seeded = init_weights(RDPN(cfg), torch.Generator().manual_seed(5))
    again = RDPN(cfg)
    again.load_state_dict(seeded.state_dict(), strict=True)
    assert os.path.isdir(tmp_path / "ckpt" / "1")
