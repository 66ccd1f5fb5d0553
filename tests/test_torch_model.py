"""Port network vs the JAX ``RDPN``: the flax init carried over with
``state_dict_from_flax``, every output key compared on the same seeded
batch (tiny config, several head/PnP variants), plus each submodule alone.

Weights use ``head.init=fan_in`` and perturbed norm/bias leaves, so that a
swapped channel or a mis-mapped leaf moves the outputs by O(1). Tolerance:
both sides are float32, but XLA's and oneDNN's convolutions sum in
different orders, and ``F.interpolate`` derives its align-corners weights
in float32 (JAX in float64): relative differences of ~1e-6 per layer
compound through the trunk and the head. Every key is held to
``RTOL`` × its own max magnitude; region ids only where the top-2 logit
margin exceeds 1e-5 (a near-tie may flip between frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.models import dummy_batch
from rdpn6d_tpu.models.conv_pnp import ConvPnPNet as JConvPnP
from rdpn6d_tpu.models.heads import DenseHead as JDenseHead
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.models import RDPN as TRDPN
from rdpn6d_tpu_torch.models.conv_pnp import ConvPnPNet as TConvPnP
from rdpn6d_tpu_torch.models.heads import DenseHead as TDenseHead
from rdpn6d_tpu_torch.utils.flax_params import (
    head_state,
    carry,
    pnp_state,
    state_dict_from_flax,
)

RTOL = 3e-5

TINY = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16", 'head.init="fan_in"']

KEYS = ["mask_logits", "coord", "coord_out", "region_logits", "rot_param",
        "rot_mat", "centroid_rel", "z_rel", "rot_ego", "trans"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the suite runs several workers on few cores
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def perturb(variables, seed=0):
    """Non-trivial norms and biases (init leaves them at 1 / 0), and z
    biased into the physical regime (~1 m)."""
    rng = np.random.RandomState(seed)

    def walk(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, coll)
                continue
            v = np.array(v, np.float32)
            if coll == "batch_stats":
                v = (rng.normal(0, 0.05, v.shape) if k == "mean"
                     else rng.uniform(0.7, 1.3, v.shape))
            elif k == "scale":
                v = v * rng.uniform(0.8, 1.2, v.shape)
            elif k == "bias":
                v = v + rng.normal(0, 0.05, v.shape)
            out[k] = v.astype(np.float32)
        return out

    params = walk(jax.device_get(variables["params"]), "params")
    stats = walk(jax.device_get(variables.get("batch_stats", {})),
                 "batch_stats")
    if "pnp_net" in params:
        params["pnp_net"]["Dense_3"]["bias"][2] = 2.0
    return params, stats


def make_batch(cfg, B, seed=0):
    rng = np.random.RandomState(seed)
    res, out = cfg.backbone.input_res, cfg.head.out_res
    K = cfg.head.num_regions
    img = np.concatenate([rng.rand(B, res, res, 3),
                          rng.randn(B, res, res, 3) * 0.1], -1)
    return {
        "roi_cls": rng.randint(0, cfg.head.num_classes, B).astype(np.int32),
        "roi_img": img.astype(np.float32),
        "roi_coord_2d": rng.rand(B, out, out, 5).astype(np.float32),
        "fps": (rng.randn(B, K, 3) * 0.05).astype(np.float32),
        "roi_extent": rng.uniform(0.05, 0.2, (B, 3)).astype(np.float32),
        "roi_cam": np.tile(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0],
                                     [0, 0, 1]], np.float32), (B, 1, 1)),
        "bbox_center": rng.uniform(200, 400, (B, 2)).astype(np.float32),
        "roi_wh": rng.uniform(60, 160, (B, 2)).astype(np.float32),
        "resize_ratio": rng.uniform(0.3, 0.6, B).astype(np.float32),
    }


def jax_forward(opts, B, seed=0, init_seed=0):
    """(cfg opts) -> (params, stats, batch, JAX outputs as numpy)."""
    cfg = JConfig().apply_opts(opts)
    model = JRDPN(cfg, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(init_seed),
                           dummy_batch(cfg, 1), train=False)
    params, stats = perturb(variables, init_seed)
    batch = make_batch(cfg, B, seed)
    out = model.apply({"params": params, "batch_stats": stats},
                      {k: jnp.asarray(v) for k, v in batch.items()},
                      train=False)
    return params, stats, batch, {k: np.asarray(out[k]) for k in KEYS}


def torch_forward(opts, params, stats, batch):
    cfg = TConfig().apply_opts(opts)
    model = TRDPN(cfg)
    model.load_state_dict(state_dict_from_flax(cfg, params, stats))
    model.eval()
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()})
    return {k: out[k].numpy() for k in KEYS}


def assert_outputs_match(ours, ref, rtol=RTOL):
    for k in KEYS:
        a, b = ours[k], ref[k]
        assert a.shape == b.shape, (k, a.shape, b.shape)
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= rtol * scale, (k, err, scale)
    lg = ref["region_logits"][..., 1:]
    top2 = np.sort(lg, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5
    ids_ours = ours["region_logits"][..., 1:].argmax(-1)
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(ids_ours[clear], lg.argmax(-1)[clear])


VARIANTS = {
    "rot_concat_false": ["backbone.rot_concat=false"],
    "rot_concat_true": ["backbone.rot_concat=true"],
    # every other branch of the assembly: bins, class-aware channels,
    # BCE mask concatenated, GN head, quaternion rotation, ABS z, egocentric
    "ce_coor_class_aware": [
        "backbone.rot_concat=true", 'head.xyz_loss="CE_coor"',
        "head.xyz_bin=8", "head.rot_class_aware=true",
        "head.mask_class_aware=true", "head.region_class_aware=true",
        "head.num_classes=3", 'head.mask_loss="BCE"',
        'pnp.mask_attention="concat"', 'head.norm="GN"',
        "head.gn_groups=8", 'pnp.rot_type="ego_quat"', 'pnp.z_type="ABS"'],
    "lie_vec_ce_mask_4layers": [
        'pnp.rot_type="allo_lie_vec"', 'head.mask_loss="CE"',
        "pnp.with_2d_coord=false", "head.num_layers=4",
        'pnp.norm="BN"', "pnp.num_layers=4"],
    "log_quat_no_region_attention": [
        'pnp.rot_type="allo_log_quat"', "pnp.region_attention=false",
        'pnp.mask_attention="none"', 'pnp.z_type="LOG"'],
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tiny_model_matches_jax(variant):
    opts = TINY + VARIANTS[variant]
    params, stats, batch, ref = jax_forward(opts, B=3)
    ours = torch_forward(opts, params, stats, batch)
    assert_outputs_match(ours, ref)


def test_state_dict_refuses_partial_tree():
    opts = TINY
    cfg = JConfig().apply_opts(opts)
    variables = JRDPN(cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), dummy_batch(cfg, 1), train=False)
    params, stats = perturb(variables)
    del params["dense_head"]["Conv_2"]
    with pytest.raises(ValueError, match="does not cover"):
        state_dict_from_flax(TConfig().apply_opts(opts), params, stats)
    with pytest.raises(ValueError, match="does not cover"):
        state_dict_from_flax(TConfig().apply_opts(opts), perturb(
            variables)[0], {})


def test_conv_pnp_reference_init_sees_gn_eps():
    """Reference init (normal 0.001) makes the conv outputs' variance
    ~1e-4, where GroupNorm's eps (flax 1e-6, torch default 1e-5) moves the
    output by ~1%: the carried eps must be flax's."""
    rng = np.random.RandomState(0)
    B, C, K = 2, 11, 32
    coord = rng.rand(B, 64, 64, C).astype(np.float32)
    region = rng.dirichlet(np.ones(K), (B, 64, 64)).astype(np.float32)
    mask = rng.rand(B, 64, 64, 1).astype(np.float32)
    ext = rng.uniform(0.05, 0.2, (B, 3)).astype(np.float32)
    jm = JConvPnP(rot_dim=6, dtype=jnp.float32, init_mode="reference")
    args = tuple(map(jnp.asarray, (coord, region, ext, mask)))
    v = jm.init(jax.random.PRNGKey(1), *args)
    r_ref, t_ref = jm.apply(v, *args)
    params = jax.device_get(v["params"])
    tm = TConvPnP(C + K, rot_dim=6, in_res=64)
    tm.load_state_dict(carry(
        lambda w: pnp_state(w, 3, "GN", 128, 8, "", ()), params))
    with torch.no_grad():
        r, t = tm(*(torch.from_numpy(x).permute(0, 3, 1, 2)
                    for x in (coord, region)), torch.from_numpy(ext),
                  torch.from_numpy(mask).permute(0, 3, 1, 2))
    for a, b in ((r, r_ref), (t, t_ref)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= RTOL * np.abs(b).max()
    tm.features[1].eps = 1e-5   # torch's default: visibly off
    with torch.no_grad():
        r2, _ = tm(*(torch.from_numpy(x).permute(0, 3, 1, 2)
                     for x in (coord, region)), torch.from_numpy(ext),
                   torch.from_numpy(mask).permute(0, 3, 1, 2))
    assert np.abs(r2.numpy() - np.asarray(r_ref)).max() > \
        10 * RTOL * np.abs(np.asarray(r_ref)).max()


@pytest.mark.parametrize("skip", [False, True])
def test_dense_head_matches_jax(skip):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 40).astype(np.float32)
    s64 = rng.randn(2, 16, 16, 6).astype(np.float32) if skip else None
    jm = JDenseHead(mask_dim=1, coord_dim=3, region_dim=5, num_filters=16,
                    dtype=jnp.float32, init_mode="fan_in")
    jargs = (jnp.asarray(x),)
    jkw = {"skip64": jnp.asarray(s64)} if skip else {}
    v = jm.init(jax.random.PRNGKey(3), *jargs, **jkw)
    params, stats = perturb(v, 3)
    ref = jm.apply({"params": params, "batch_stats": stats}, *jargs, **jkw)
    tm = TDenseHead(40, 1, 3, 5, num_filters=16,
                    skip_channels=6 if skip else 0)
    tm.load_state_dict(carry(
        lambda w: head_state(w, 3, "BN", "", ()), params, stats))
    tm.eval()
    with torch.no_grad():
        outs = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(s64).permute(0, 3, 1, 2)
                  if skip else None)
    for a, b in zip(outs, ref):
        b = np.asarray(b)
        a = a.permute(0, 2, 3, 1).numpy()
        assert np.abs(a - b).max() <= RTOL * np.abs(b).max()
