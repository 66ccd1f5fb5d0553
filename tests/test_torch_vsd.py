"""VSD in the port against the JAX package: the host rasterizer, the VSD
error from depth maps, the memoized VSD error function, the BOP19 AR with
VSD, and the numpy exact pose errors.

The port renders with its own ``csrc/rasterizer.cpp``, built by
``ops/cuda_build.build_host`` with ``-ffp-contract=off`` and no
``-march=native``; the JAX package loads its own library, built with
``-O3 -march=native``, where GCC may contract to FMAs. So the two renders
may part in the last bits, and where two triangles meet, the z-test may
pick the other one. Tolerances, measured on these meshes: covered pixels
(depth > 0) equal on >= 99.9% of them (0 differed); depth within 1e-6
relative on >= 99.9% of covered pixels (all but 3 of 133672) and within
1e-4 relative everywhere (7.2e-6 at most); xyz within 1e-6 m on >= 99.9%
of covered pixels. VSD from the same depth maps: equal (numpy on both
sides). VSD through each package's renders: within 1e-3 per tau; the
render cache's counters equal; the BOP19 AR with VSD equal. The numpy
exact errors: equal.
"""

import os

import numpy as np
import pytest

from rdpn6d_tpu.evaluation import bop_errors as jerr
from rdpn6d_tpu.evaluation import bop_score as jscore
from rdpn6d_tpu.evaluation import pose_error as jpe
from rdpn6d_tpu.ops.rasterizer import render_mesh as j_render
from rdpn6d_tpu_torch.data.synthetic import LM_K, mini_meshes
from rdpn6d_tpu_torch.evaluation import bop_errors as terr
from rdpn6d_tpu_torch.evaluation import bop_score as tscore
from rdpn6d_tpu_torch.evaluation import pose_error as tpe
from rdpn6d_tpu_torch.ops import cuda_build
from rdpn6d_tpu_torch.ops.rasterizer import render_mesh as t_render

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 480, 640
TAUS = tuple(float(t) for t in np.arange(0.05, 0.51, 0.05))


def _rotation(rng):
    q, r = np.linalg.qr(rng.randn(3, 3))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


@pytest.fixture(scope="module")
def meshes():
    """The mini dataset's tetrahedron, cube and L-prism, in metres."""
    return {oid: ((v / 1000.0).astype(np.float32), f)
            for oid, (v, f) in mini_meshes().items()}


def _poses(n, seed):
    rng = np.random.RandomState(seed)
    return [(_rotation(rng), np.array([rng.uniform(-0.1, 0.1),
                                       rng.uniform(-0.1, 0.1),
                                       rng.uniform(0.5, 0.9)]))
            for _ in range(n)]


def test_render_mesh_matches_jax(meshes):
    cov = off = depth_far = xyz_far = 0
    worst = 0.0
    for i, (R, t) in enumerate(_poses(24, 0)):
        v, f = meshes[(1, 5, 8)[i % 3]]
        dj, xj = j_render(v, f, LM_K, R, t, H, W)
        dt, xt = t_render(v, f, LM_K, R, t, H, W)
        assert dt.dtype == np.float32 and dt.shape == (H, W)
        assert xt.shape == (H, W, 3)
        m = dj > 0
        cov += int(m.sum())
        off += int((m != (dt > 0)).sum())
        both = m & (dt > 0)
        rel = np.abs(dj - dt)[both] / dj[both]
        depth_far += int((rel > 1e-6).sum())
        xyz_far += int((np.abs(xj - xt)[both].max(-1) > 1e-6).sum())
        worst = max(worst, float(rel.max()))
        # the off-mesh pixels are zero in both
        assert not dt[~(dt > 0)].any() and not xt[~(dt > 0)].any()
    assert cov > 50000
    assert off <= 1e-3 * cov
    assert depth_far <= 1e-3 * cov and xyz_far <= 1e-3 * cov
    assert worst <= 1e-4


def test_render_mesh_is_deterministic_and_culls_behind_camera(meshes):
    v, f = meshes[8]
    R, t = _poses(1, 3)[0]
    a = t_render(v, f, LM_K, R, t, H, W)
    b = t_render(v, f, LM_K, R, t, H, W)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    d, _ = t_render(v, f, LM_K, R, np.array([0.0, 0.0, -0.5]), H, W)
    assert not d.any()
    with pytest.raises(ValueError, match="face index"):
        t_render(v, f + len(v), LM_K, R, t, H, W)


def _scene(meshes, oid, R, t, seed):
    """Scene depth: the object at (R, t) over a plane at 1.2 m, a band of
    missing depth, and an occluding slab over part of the object."""
    d, _ = t_render(*meshes[oid], LM_K, R, t, H, W)
    scene = np.where(d > 0, d, 1.2).astype(np.float32)
    rng = np.random.RandomState(seed)
    y0 = rng.randint(150, 300)
    scene[y0:y0 + 30] = 0.0
    x0 = rng.randint(250, 350)
    scene[:, x0:x0 + 25] = np.minimum(scene[:, x0:x0 + 25], 0.3)
    return scene


def _perturbed(R, t, rng, scale):
    dR = _rotation(np.random.RandomState(rng.randint(1 << 30)))
    w = scale * 0.3
    R2 = (np.eye(3) * (1 - w) + dR * w)
    u, _, vt = np.linalg.svd(R2)
    return u @ vt @ R, t + rng.randn(3) * 0.01 * scale


def test_vsd_from_depths_matches_jax_exactly(meshes):
    rng = np.random.RandomState(4)
    for i, (R, t) in enumerate(_poses(6, 1)):
        oid = (1, 5, 8)[i % 3]
        scene = _scene(meshes, oid, R, t, i)
        Re, te = _perturbed(R, t, rng, 0.5 * i)
        d_est, _ = t_render(*meshes[oid], LM_K, Re, te, H, W)
        d_gt, _ = t_render(*meshes[oid], LM_K, R, t, H, W)
        for kw in ({}, {"cost_type": "tlinear"},
                   {"normalized_by_diameter": False}):
            e_t = terr.vsd_from_depths(d_est, d_gt, scene, taus=TAUS,
                                       diameter=0.12, **kw)
            e_j = jerr.vsd_from_depths(d_est, d_gt, scene, taus=TAUS,
                                       diameter=0.12, **kw)
            assert e_t == e_j
        if i:
            assert 0.0 < max(e_t) < 1.0
    empty = np.zeros((H, W), np.float32)
    assert terr.vsd_from_depths(empty, empty, empty, taus=TAUS) == \
        [1.0] * len(TAUS)


def test_vsd_matches_jax(meshes):
    rng = np.random.RandomState(5)
    for i, (R, t) in enumerate(_poses(4, 2)):
        oid = (1, 5, 8)[i % 3]
        scene = _scene(meshes, oid, R, t, i)
        Re, te = _perturbed(R, t, rng, 1.0)
        args = (Re, te, R, t, scene, LM_K, *meshes[oid])
        e_t = terr.vsd(*args, taus=TAUS, diameter=0.12)
        e_j = jerr.vsd(*args, taus=TAUS, diameter=0.12)
        np.testing.assert_allclose(e_t, e_j, rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def targets_set(meshes):
    """Two frames, three objects, one with two GT instances, and
    estimates at three distances from the GT (one exact, one far off, one
    object missed)."""
    rng = np.random.RandomState(7)
    gts, ests, scenes, targets = {}, [], {}, []
    K = LM_K.astype(np.float32)
    for im_id in range(2):
        gl = []
        scene = np.full((H, W), 1.2, np.float32)
        for j, (oid, (R, t)) in enumerate(zip((1, 5, 5, 8),
                                              _poses(4, 10 + im_id))):
            t = t + np.array([0.08 * (j - 1.5), 0.0, 0.0])
            d, _ = t_render(*meshes[oid], LM_K, R, t, H, W)
            scene = np.where((d > 0) & (d < scene), d, scene)
            gl.append({"obj_id": oid, "R": R, "t": t, "K": K})
        gts[(3, im_id)] = gl
        scenes[(3, im_id)] = scene
        for oid in (1, 5, 8):
            targets.append({"scene_id": 3, "im_id": im_id, "obj_id": oid,
                            "inst_count": 2 if oid == 5 else 1})
        for j, g in enumerate(gl):
            if im_id == 1 and j == 3:
                continue                               # a missed object
            R, t = (g["R"], g["t"]) if j == 0 else _perturbed(
                g["R"], g["t"], rng, 0.3 * j)
            ests.append({"scene_id": 3, "im_id": im_id, "obj_id": g["obj_id"],
                         "score": float(rng.uniform(0.5, 1.0)),
                         "R": R, "t": t})
    return gts, ests, scenes, targets


def _vsd_fns(meshes, scenes, diameters):
    def loader(s, i):
        return scenes[(s, i)]

    return (tscore.make_vsd_error_fn(meshes, loader, diameters),
            jscore.make_vsd_error_fn(meshes, loader, diameters))


def test_make_vsd_error_fn_matches_jax(meshes, targets_set):
    gts, ests, scenes, _ = targets_set
    diameters = {1: 0.11, 5: 0.139, 8: 0.125}
    t_fn, j_fn = _vsd_fns(meshes, scenes, diameters)
    seen = set()
    for e in ests:
        for g in gts[(e["scene_id"], e["im_id"])]:
            if g["obj_id"] != e["obj_id"]:
                continue
            et, ej = t_fn(e, g), j_fn(e, g)
            assert et.shape == ej.shape == (len(TAUS),)
            np.testing.assert_allclose(et, ej, rtol=0, atol=1e-3)
            seen.add(bool(et.max() < 1e-6))
    assert seen == {True, False}       # exact and perturbed estimates
    assert t_fn.render_cache_info() == j_fn.render_cache_info()
    info = t_fn.render_cache_info()
    assert info.hits > 0 and info.misses > 0


def test_bop19_average_recalls_with_vsd_matches_jax(meshes, targets_set):
    gts, ests, scenes, targets = targets_set
    diameters = {1: 0.11, 5: 0.139, 8: 0.125}
    models = {oid: v for oid, (v, _) in meshes.items()}
    sym = {oid: np.eye(3, dtype=np.float32)[None] for oid in meshes}
    t_fn, j_fn = _vsd_fns(meshes, scenes, diameters)
    out = {}
    for name, mod, fn in (("port", tscore, t_fn), ("jax", jscore, j_fn)):
        g = {k: [dict(x) for x in v] for k, v in gts.items()}
        out[name] = mod.bop19_average_recalls(
            ests, g, targets, models, sym, diameters, im_width=W,
            with_vsd=fn)
    assert out["port"] == out["jax"]
    assert set(out["port"]) == {"AR_mssd", "AR_mspd", "AR_vsd", "AR"}
    assert 0.0 < out["port"]["AR_vsd"] < 1.0
    assert out["port"]["AR"] == pytest.approx(
        (out["port"]["AR_vsd"] + out["port"]["AR_mssd"]
         + out["port"]["AR_mspd"]) / 3.0)


def test_numpy_exact_errors_match_jax():
    rng = np.random.RandomState(8)
    pts = rng.randn(500, 3) * 0.05
    for i in range(5):
        R_gt, R_est = _rotation(rng), _rotation(rng)
        t_gt = np.array([0.0, 0.0, 0.7]) + rng.randn(3) * 0.05
        t_est = t_gt + rng.randn(3) * 0.02 * i
        if i == 0:
            R_est = R_gt
        args = (R_est, t_est, R_gt, t_gt, pts)
        assert tpe.add_np(*args) == jpe.add_np(*args)
        assert tpe.adi_np(*args) == jpe.adi_np(*args)
        assert tpe.re_np(R_est, R_gt) == jpe.re_np(R_est, R_gt)
        assert tpe.te_np(t_est, t_gt) == jpe.te_np(t_est, t_gt)
        assert tpe.proj_2d_np(*args, LM_K) == jpe.proj_2d_np(*args, LM_K)
        assert isinstance(tpe.adi_np(*args), float)
    assert tpe.re_np(R_gt, R_gt) < 1e-4 and tpe.add_np(
        R_gt, t_gt, R_gt, t_gt, pts) == 0.0


def test_rasterizer_is_built_from_the_ports_own_source():
    """The library is compiled from ``rdpn6d_tpu_torch/csrc/rasterizer.cpp``
    into ``rdpn6d_tpu_torch/_build/`` at the fixed host flags; nothing of
    the JAX package's ``csrc/`` is built or loaded."""
    built = cuda_build.build_host("rasterizer")
    assert os.path.dirname(built.path) == os.path.join(
        ROOT, "rdpn6d_tpu_torch", "_build")
    assert os.path.basename(built.path).startswith("rasterizer-")
    assert "-ffp-contract=off" in cuda_build.HOST_FLAGS
    assert not any("march" in f for f in cuda_build.HOST_FLAGS)
    src = os.path.join(cuda_build.CSRC_DIR, "rasterizer.cpp")
    assert os.path.isfile(src)
    with open(os.path.join(ROOT, "rdpn6d_tpu", "csrc", "rasterizer",
                           "rasterizer.cpp")) as f:
        jax_src = f.read()
    with open(src) as f:
        port_src = f.read()
    # the same function, byte for byte, below the header comment
    body = jax_src[jax_src.index("#include"):]
    assert port_src.endswith(body)
    lib = cuda_build.load_host("rasterizer")
    assert os.path.realpath(lib._name) == os.path.realpath(built.path)


def test_host_build_failure_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="failed on .*broken.cpp"):
        cuda_build.build_host("broken")
    assert not [p for p in os.listdir(tmp_path / "_build")
                if p.endswith(".so")]
