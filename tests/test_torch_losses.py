"""The port's ``compute_losses`` against the JAX package's: every loss key
and its gradient with respect to every model output, on the same seeded
outputs and targets, under each coordinate, mask and point-matching
branch (the symmetric one included) and the optional terms.

Tolerance: both sides are float32 reductions over a few thousand terms in
other orders, 1e-5 relative to each value's (or gradient's) magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.losses import compute_losses as j_losses
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data.synthetic import dummy_train_batch
from rdpn6d_tpu_torch.geometry import closest_rot
from rdpn6d_tpu_torch.losses import compute_losses as t_losses

RTOL = 1e-5
BASE = ["head.out_res=16", "head.num_regions=6"]
B = 4


def _rotations(rng, n):
    q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    return (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)


def _axis_rot(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def make_case(opts, seed=0):
    cfg = TConfig().apply_opts(BASE + opts)
    h = cfg.head
    rng = np.random.RandomState(seed)
    batch = dummy_train_batch(cfg, B, seed=seed)
    # a non-trivial symmetry bank: 4-fold about z, identity-padded to 6
    bank = [_axis_rot([0, 0, 1], np.pi / 2 * k) for k in range(4)]
    batch["sym_rots"] = np.tile(np.stack(bank + [np.eye(3)] * 2)[None],
                                (B, 1, 1, 1)).astype(np.float32)
    H = h.out_res
    out = {
        "mask_logits": rng.randn(B, H, H, h.mask_dim),
        "coord": rng.rand(B, H, H, 3),
        "coord_out": rng.randn(B, H, H, h.coord_dim),
        "region_logits": rng.randn(B, H, H, h.region_dim),
        # near the GT, so the symmetric pick and the angles are O(0.1)
        "rot_ego": np.einsum("bij,bjk->bik", batch["gt_rot"],
                             _rotations(rng, B) * 0.02
                             + 0.98 * np.eye(3)),
        "trans": batch["gt_trans"] + rng.normal(0, 0.01, (B, 3)),
        "centroid_rel": rng.randn(B, 2) * 0.1,
        "z_rel": rng.uniform(5, 15, B),
    }
    out["rot_ego"] = np.stack([u @ vt for u, _, vt in
                               map(np.linalg.svd, out["rot_ego"])])
    if cfg.loss.pm_loss_sym:
        # sample i sits nearest the GT turned by bank member i % 4
        out["rot_ego"] = np.stack([r @ bank[i % 4] for i, r
                                   in enumerate(out["rot_ego"])])
    if cfg.loss.use_mtl:
        for name in ("mask", "coor_x", "coor_y", "coor_z", "region"):
            out[f"log_var_{name}"] = np.float32(rng.randn() * 0.3)
    if h.xyz_loss == "CE_coor":
        batch["roi_xyz_bin"] = rng.randint(0, h.xyz_bin + 1,
                                           (B, H, H, 3)).astype(np.int32)
    if h.mask_loss in ("BCE", "CE"):
        for k in ("roi_mask_trunc", "roi_mask_visib", "roi_mask_obj"):
            batch[k] = (rng.rand(B, H, H) > 0.5).astype(np.float32)
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    return opts, out, batch


VARIANTS = {
    "defaults_pm_r_only": [],
    "ce_coor_bce_mask": ['head.xyz_loss="CE_coor"', "head.xyz_bin=8",
                         'head.mask_loss="BCE"', 'head.xyz_loss_mask="obj"'],
    "mask_ce_region_trunc": ['head.mask_loss="CE"',
                             'head.region_loss_mask="trunc"',
                             'head.mask_loss_gt="visib"', "head.xyz_lw=0.5",
                             "head.region_lw=2.0", "head.mask_lw=3.0"],
    "pm_rt": ["loss.pm_r_only=false"],
    "pm_disentangle_t": ["loss.pm_r_only=false",
                         "loss.pm_disentangle_t=true"],
    "pm_disentangle_t_points": ["loss.pm_r_only=false",
                                "loss.pm_disentangle_t=true",
                                "loss.pm_t_use_points=true"],
    "pm_disentangle_z": ["loss.pm_r_only=false", "loss.pm_lw=2.5",
                         "loss.pm_disentangle_z=true"],
    "pm_disentangle_z_points": ["loss.pm_r_only=false",
                                "loss.pm_disentangle_z=true",
                                "loss.pm_t_use_points=true"],
    "pm_symmetric_smooth_l1": ["loss.pm_loss_sym=true",
                               'loss.pm_loss_type="smooth_l1"',
                               "loss.pm_smooth_l1_beta=0.05",
                               "loss.pm_norm_by_extent=false"],
    "pm_mse_rot_angular_bind_trans": [
        'loss.pm_loss_type="MSE"', "loss.rot_lw=1.0", "loss.bind_lw=0.5",
        "loss.trans_lw=2.0", "loss.centroid_lw=0.7", "loss.z_lw=0.3"],
    "rot_mse_trans_lpnp": ['loss.rot_loss_type="mse"', "loss.rot_lw=1.0",
                           "loss.trans_lw=1.0",
                           "loss.trans_loss_disentangle=false"],
    "mtl": ["loss.use_mtl=true"],
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_losses_and_grads_match_jax(variant):
    opts, out, batch = make_case(VARIANTS[variant])
    jcfg = JConfig().apply_opts(BASE + opts)
    tcfg = TConfig().apply_opts(BASE + opts)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref, vjp = jax.vjp(lambda o: j_losses(jcfg, o, jbatch),
                       {k: jnp.asarray(v) for k, v in out.items()})
    tout = {k: torch.tensor(v, requires_grad=True) for k, v in out.items()}
    ours = t_losses(tcfg, tout, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    assert set(ours) == set(ref), (sorted(ours), sorted(ref))
    for key in ref:
        a, b = float(ours[key].detach()), float(ref[key])
        assert np.isfinite(a) and abs(a - b) <= RTOL * max(abs(b), 1e-3), \
            (key, a, b)
        ct = {k: jnp.zeros_like(v) for k, v in ref.items()}
        ct[key] = jnp.ones_like(ref[key])
        (g_ref,) = vjp(ct)
        g_ours = torch.autograd.grad(ours[key], list(tout.values()),
                                     retain_graph=True, allow_unused=True)
        for name, g in zip(tout, g_ours):
            gr = np.asarray(g_ref[name])
            g = np.zeros_like(gr) if g is None else g.numpy()
            scale = max(float(np.abs(gr).max()), 1e-6)
            assert np.abs(g - gr).max() <= RTOL * scale + 1e-9, \
                (key, name, float(np.abs(g - gr).max()), scale)


def test_closest_rot_picks_symmetric_equivalent():
    rng = np.random.RandomState(1)
    R_gt = torch.from_numpy(_rotations(rng, 3))
    bank = torch.from_numpy(np.stack([_axis_rot([0, 0, 1], np.pi / 2 * k)
                                      for k in range(4)]).astype(np.float32))
    # the estimate is the GT turned by the bank's 3rd member, plus noise
    est = R_gt @ bank[2] @ torch.from_numpy(
        _axis_rot([1, 2, 3], 0.01).astype(np.float32))
    got = closest_rot(est, R_gt, bank.expand(3, 4, 3, 3))
    torch.testing.assert_close(got, R_gt @ bank[2])
