"""Port geometry vs ``rdpn6d_tpu.geometry`` on the same seeded inputs.

Tolerance: both sides compute in float32 with the same formulas, so they
agree to a few float32 ulps of the result's magnitude; atol 1e-6 on
unit-scale values (rotations, unit vectors) and rtol 1e-6 on pixel /
metre quantities.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdpn6d_tpu import geometry as jg
from rdpn6d_tpu_torch import geometry as tg

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _j(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _rand_rot(rng, n):
    q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    d = np.sign(np.linalg.det(q))
    return (q * d[:, None, None]).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 1e-15])
def test_normalize_and_ortho6d(scale):
    # 1e-15: the tiny-init regime where a direct f32 norm underflows
    rng = np.random.RandomState(0)
    v = (rng.randn(64, 6) * scale).astype(np.float32)
    np.testing.assert_allclose(tg.normalize(_t(v)).numpy(),
                               np.asarray(jg.normalize(_j(v))), atol=ATOL)
    R = tg.ortho6d_to_mat(_t(v)).numpy()
    np.testing.assert_allclose(R, np.asarray(jg.ortho6d_to_mat(_j(v))),
                               atol=ATOL)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)


def test_quat_axangle_exp_map():
    rng = np.random.RandomState(1)
    q = rng.randn(64, 4).astype(np.float32)
    np.testing.assert_allclose(tg.quat_to_mat(_t(q)).numpy(),
                               np.asarray(jg.quat_to_mat(_j(q))), atol=ATOL)
    ax = rng.randn(64, 3).astype(np.float32)
    ang = rng.uniform(-3, 3, 64).astype(np.float32)
    np.testing.assert_allclose(
        tg.axangle_to_mat(_t(ax), _t(ang)).numpy(),
        np.asarray(jg.axangle_to_mat(_j(ax), _j(ang))), atol=ATOL)
    vec = (ax * np.array([1.0, 1e-9, 1.0], np.float32)[:, None].T)
    np.testing.assert_allclose(tg.exp_map(_t(vec)).numpy(),
                               np.asarray(jg.exp_map(_j(vec))), atol=ATOL)


def test_angular_distance():
    rng = np.random.RandomState(2)
    r1, r2 = _rand_rot(rng, 64), _rand_rot(rng, 64)
    # arccos near 0/pi magnifies ulp differences of the trace: compare
    # the angle to 1e-5 rad, and identical rotations give exactly 0 both
    np.testing.assert_allclose(
        tg.angular_distance(_t(r1), _t(r2)).numpy(),
        np.asarray(jg.angular_distance(_j(r1), _j(r2))), atol=1e-5)
    np.testing.assert_allclose(
        tg.angular_distance(_t(r1), _t(r2), eps=1e-7).numpy(),
        np.asarray(jg.angular_distance(_j(r1), _j(r2), eps=1e-7)),
        atol=1e-5)


def test_allo_to_ego():
    rng = np.random.RandomState(3)
    t = np.concatenate([rng.uniform(-0.3, 0.3, (63, 2)),
                        rng.uniform(0.5, 1.5, (63, 1))], 1)
    t = np.concatenate([t, [[0.0, 0.0, 1.0]]]).astype(np.float32)  # on-axis
    R = _rand_rot(rng, 64)
    ego = tg.allo_to_ego_mat(_t(t), _t(R)).numpy()
    np.testing.assert_allclose(
        ego, np.asarray(jg.allo_to_ego_mat(_j(t), _j(R))), atol=ATOL)
    # the inverse correction, on the JAX side, recovers the input
    np.testing.assert_allclose(
        np.asarray(jg.ego_to_allo_mat(_j(t), _j(ego))), R, atol=1e-5)


def test_project_backproject_crop_K():
    rng = np.random.RandomState(4)
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                 np.float32)
    pts = (rng.randn(5, 100, 3) * 0.05).astype(np.float32)
    R = _rand_rot(rng, 5)
    t = np.concatenate([rng.uniform(-0.1, 0.1, (5, 2)),
                        rng.uniform(0.6, 1.2, (5, 1))], 1).astype(np.float32)
    Kb = np.broadcast_to(K, (5, 3, 3)).copy()
    np.testing.assert_allclose(
        tg.project(_t(pts), _t(Kb), _t(R), _t(t)).numpy(),
        np.asarray(jg.project(_j(pts), _j(Kb), _j(R), _j(t))), rtol=1e-6)
    np.testing.assert_allclose(
        tg.transform_pts(_t(pts), _t(R), _t(t)).numpy(),
        np.asarray(jg.transform_pts(_j(pts), _j(R), _j(t))), atol=ATOL)
    depth = rng.uniform(0.5, 1.5, (2, 24, 32)).astype(np.float32)
    np.testing.assert_allclose(
        tg.backproject_depth(_t(depth), _t(Kb[:2])).numpy(),
        np.asarray(jg.backproject_depth(_j(depth), _j(Kb[:2]))), rtol=1e-6,
        atol=1e-7)
    A = rng.randn(5, 2, 3).astype(np.float32)
    np.testing.assert_allclose(tg.crop_K(_t(Kb), _t(A)).numpy(),
                               np.asarray(jg.crop_K(_j(Kb), _j(A))),
                               rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("z_type,is_allo", [("REL", True), ("ABS", True),
                                            ("LOG", False),
                                            ("NEG_LOG", True)])
def test_recover_pose_centroid_z(z_type, is_allo):
    rng = np.random.RandomState(5)
    B = 16
    R = _rand_rot(rng, B)
    c = rng.uniform(-0.3, 0.3, (B, 2)).astype(np.float32)
    z = rng.uniform(0.5, 2.0, B).astype(np.float32)
    K = np.broadcast_to(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0],
                                  [0, 0, 1]], np.float32), (B, 3, 3)).copy()
    ctr = rng.uniform(100, 500, (B, 2)).astype(np.float32)
    wh = rng.uniform(40, 200, (B, 2)).astype(np.float32)
    rr = rng.uniform(0.2, 1.0, B).astype(np.float32)
    args = (R, c, z, K, ctr, wh, rr)
    Rt, tt = tg.recover_pose_centroid_z(*map(_t, args), z_type=z_type,
                                        is_allo=is_allo)
    Rj, tj = jg.recover_pose_centroid_z(*map(_j, args), z_type=z_type,
                                        is_allo=is_allo)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=ATOL)
    with pytest.raises(ValueError):
        tg.recover_pose_centroid_z(*map(_t, args), z_type="bogus")


def _rot_of_angle(rng, n, lo, hi):
    """n rotations by angles in [lo, hi] about random axes."""
    ax = rng.randn(n, 3)
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    ang = rng.uniform(lo, hi, n)
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -ax[:, 2], ax[:, 1], -ax[:, 0]
    K = K - K.transpose(0, 2, 1)
    R = np.eye(3) + np.sin(ang)[:, None, None] * K \
        + (1 - np.cos(ang))[:, None, None] * (K @ K)
    return R.astype(np.float32)


# random rotations, and the two ends where the conversions are delicate:
# near identity (a tiny axis-angle) and near a half turn (w ~ 0)
REGIMES = {"random": (0.0, np.pi), "near_identity": (1e-4, 1e-3),
           "near_pi": (np.pi - 1e-2, np.pi - 1e-3)}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_mat_to_quat_and_log_map(regime):
    rng = np.random.RandomState(6)
    R = _rot_of_angle(rng, 64, *REGIMES[regime])
    q = tg.mat_to_quat(_t(R)).numpy()
    np.testing.assert_allclose(q, np.asarray(jg.mat_to_quat(_j(R))),
                               atol=ATOL)
    assert (q[:, 0] >= 0).all()
    np.testing.assert_allclose(tg.quat_to_mat(_t(q)).numpy(), R, atol=1e-5)
    v = tg.log_map(_t(R)).numpy()
    np.testing.assert_allclose(v, np.asarray(jg.log_map(_j(R))), atol=1e-5)
    np.testing.assert_allclose(tg.exp_map(_t(v)).numpy(), R, atol=1e-5)


def test_quat_mul_axangle_to_quat_euler():
    rng = np.random.RandomState(7)
    a, b = rng.randn(2, 64, 4).astype(np.float32)
    np.testing.assert_allclose(tg.quat_mul(_t(a), _t(b)).numpy(),
                               np.asarray(jg.quat_mul(_j(a), _j(b))),
                               atol=ATOL)
    ax = rng.randn(64, 3).astype(np.float32)
    ang = rng.uniform(-3.1, 3.1, 64).astype(np.float32)
    q = tg.axangle_to_quat(_t(ax), _t(ang))
    np.testing.assert_allclose(
        q.numpy(), np.asarray(jg.axangle_to_quat(_j(ax), _j(ang))),
        atol=ATOL)
    np.testing.assert_allclose(tg.quat_to_mat(q).numpy(),
                               tg.axangle_to_mat(_t(ax), _t(ang)).numpy(),
                               atol=1e-5)
    from rdpn6d_tpu.geometry.rotations import euler_to_mat as j_euler

    rx, ry, rz = rng.uniform(-3.1, 3.1, (3, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tg.euler_to_mat(_t(rx), _t(ry), _t(rz)).numpy(),
        np.asarray(j_euler(_j(rx), _j(ry), _j(rz))), atol=ATOL)


@pytest.mark.parametrize("regime", list(REGIMES))
def test_se3_compose_invert_to_homo(regime):
    from rdpn6d_tpu_torch.geometry import se3

    rng = np.random.RandomState(8)
    Ra = _rot_of_angle(rng, 16, *REGIMES[regime])
    Rb = _rand_rot(rng, 16)
    ta, tb = rng.uniform(-1, 1, (2, 16, 3)).astype(np.float32)
    R, t = tg.compose(_t(Ra), _t(ta), _t(Rb), _t(tb))
    jR, jt = jg.compose(_j(Ra), _j(ta), _j(Rb), _j(tb))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=ATOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=ATOL)
    Ri, ti = tg.invert(_t(Ra), _t(ta))
    jRi, jti = jg.invert(_j(Ra), _j(ta))
    np.testing.assert_allclose(Ri.numpy(), np.asarray(jRi), atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(jti), atol=ATOL)
    # a pose composed with its inverse is the identity
    R0, t0 = tg.compose(Ri, ti, _t(Ra), _t(ta))
    np.testing.assert_allclose(R0.numpy(), np.broadcast_to(np.eye(3),
                                                           R0.shape),
                               atol=1e-6)
    np.testing.assert_allclose(t0.numpy(), 0.0, atol=1e-6)
    T4 = tg.to_homo(_t(Ra), _t(ta))
    np.testing.assert_array_equal(T4.numpy(),
                                  np.asarray(jg.to_homo(_j(Ra), _j(ta))))
    assert se3.transform_pts is tg.transform_pts
