"""The port's evaluator and scoring against the JAX package on seeded poses:
``PoseEvaluator.compute_errors`` / ``evaluate`` / ``bop_rows``,
``format_table``, ``score.py``, ``dump_recall_curves``, ``mssd`` /
``mspd``, the BOP19 matching and average recalls and VSD's error fn.

Tolerances: ADD / ADI / te within 1e-6 m and re within 1e-4 degrees
(float32 on both sides: an ulp of the cosine moves a rotation error of
6 degrees by ~4e-5 degrees, so estimates are drawn 6-20 degrees off; JAX takes ADI's squared distances in the expanded
form |g|^2 - 2 g.e + |e|^2, the port in the direct form, so the port's ADI
is also held to the float64 KD-tree ``adi_np`` within 1e-6 m); proj within
1e-3 px (float32 projections of ~500 px). The poses are drawn so that no
error lies within 1e-5 of a recall threshold or an AUC grid point, so the
recall tables are held equal. Where both packages run the same numpy code
on the same inputs (score.py, the curves, BOP19 matching), results are
held equal.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from rdpn6d_tpu.evaluation import bop_errors as jbe
from rdpn6d_tpu.evaluation import bop_score as jbs
from rdpn6d_tpu.evaluation import plots as jplots
from rdpn6d_tpu.evaluation import score as jscore
from rdpn6d_tpu.evaluation.evaluator import PoseEvaluator as JEvaluator
from rdpn6d_tpu.evaluation.evaluator import format_table as j_table
from rdpn6d_tpu.evaluation.pose_error import adi_np
from rdpn6d_tpu_torch.evaluation import bop_errors as tbe
from rdpn6d_tpu_torch.evaluation import bop_score as tbs
from rdpn6d_tpu_torch.evaluation import plots as tplots
from rdpn6d_tpu_torch.evaluation import score as tscore
from rdpn6d_tpu_torch.evaluation.evaluator import PoseEvaluator as TEvaluator
from rdpn6d_tpu_torch.evaluation.evaluator import format_table as t_table
from rdpn6d_tpu_torch.geometry import symmetry_transforms

K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
N_PRED = {"ape": 9, "can": 7, "eggbox": 6}
N_GTS = {"ape": 11, "can": 7, "eggbox": 6, "glue": 3}   # misses pad +inf
SYM = symmetry_transforms({"symmetries_discrete": [
    [-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]]}, trans_scale=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rotations(rng, n, lo_deg, hi_deg):
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.deg2rad(rng.uniform(lo_deg, hi_deg, n))
    return Rotation.from_rotvec(axis * ang[:, None]).as_matrix()


@pytest.fixture(scope="module")
def poses():
    """Per object: model points on a box surface, GT poses 0.6-1 m away,
    estimates 6-20 degrees and 0.3-4 cm off (the symmetric object's
    around its flipped pose half the time)."""
    rng = np.random.RandomState(11)
    models, diameters, sym_rots, rows = {}, {}, {}, []
    for k, obj in enumerate(N_GTS):
        ext = rng.uniform(0.06, 0.2, 3)
        p = rng.uniform(-0.5, 0.5, (400, 3))
        face = rng.randint(0, 3, 400)
        p[np.arange(400), face] = np.sign(p[np.arange(400), face]) * 0.5
        models[obj] = (p * ext).astype(np.float32)
        diameters[obj] = float(np.linalg.norm(ext))
        sym_rots[obj] = SYM[0] if obj == "eggbox" else None
        n = N_PRED.get(obj, 0)
        R_gt = Rotation.random(n, random_state=k).as_matrix() if n else \
            np.zeros((0, 3, 3))
        t_gt = np.c_[rng.uniform(-0.1, 0.1, (n, 2)), rng.uniform(0.6, 1, n)]
        R_est = _rotations(rng, n, 6, 20) @ R_gt
        if obj == "eggbox":
            R_est[::2] = R_est[::2] @ SYM[0][1]
        shift = rng.randn(n, 3)
        t_est = t_gt + shift / np.linalg.norm(shift, axis=1, keepdims=True) \
            * rng.uniform(0.003, 0.04, (n, 1))
        for i in range(n):
            rows.append((obj, R_est[i], t_est[i], R_gt[i], t_gt[i],
                         rng.randint(1, 4), rng.randint(0, 50),
                         rng.uniform(0.3, 1.0), rng.uniform(0.01, 0.2)))
    order = rng.permutation(len(rows))
    return models, diameters, sym_rots, [rows[i] for i in order]


def _fill(evaluator, rows):
    for lo, hi in ((0, 10), (10, len(rows))):     # two chunks
        chunk = rows[lo:hi]
        col = list(zip(*chunk))
        evaluator.process_batch(
            list(col[0]), np.stack(col[1]), np.stack(col[2]),
            np.stack(col[3]), np.stack(col[4]),
            np.broadcast_to(K, (len(chunk), 3, 3)),
            scene_ids=np.array(col[5]), im_ids=np.array(col[6]),
            scores=np.array(col[7]), times=np.array(col[8]))
    return evaluator


@pytest.fixture(scope="module")
def evaluators(poses):
    models, diameters, sym_rots, rows = poses
    kw = dict(models=models, diameters=diameters, sym_rots=sym_rots,
              n_gts=N_GTS)
    return (_fill(JEvaluator(**kw), rows),
            _fill(TEvaluator(**kw, device="cpu"), rows))


TOL = {"ad": 1e-6, "add": 1e-6, "adi": 1e-6, "te": 1e-6, "re": 1e-4,
       "proj": 1e-3}


def test_compute_errors_match_jax(evaluators, poses):
    j_ev, t_ev = evaluators
    j, t = j_ev.compute_errors(), t_ev.compute_errors()
    assert list(t) == list(j) == list(N_GTS)
    for obj in j:
        assert sorted(t[obj]) == sorted(j[obj])
        for k, tol in TOL.items():
            a, b = t[obj][k], j[obj][k]
            assert a.shape == (N_GTS[obj],) and a.dtype == b.dtype
            np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
            fin = np.isfinite(b)
            np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=tol,
                                       err_msg=f"{obj} {k}")
    # ADI against the exact float64 KD-tree distances
    models, _, _, rows = poses
    for obj, n in N_PRED.items():
        mine = [r for r in rows if r[0] == obj]
        exact = [adi_np(r[1], r[2], r[3], r[4],
                        models[obj].astype(np.float64)) for r in mine]
        np.testing.assert_allclose(t[obj]["adi"][:n], exact, rtol=0,
                                   atol=1e-6)
    assert t_ev.compute_errors() is t    # memoized until a new chunk


def _thresholds(diameter):
    grid = np.arange(0.0, 0.1 + 1e-9, 0.001)
    return {"ad": np.r_[diameter * np.array([0.02, 0.05, 0.1]), grid,
                        np.linspace(0.01, 0.1, 10), 0.02],
            "re": np.array([2.0, 5, 10]), "te": np.array([0.02, 0.05, 0.1]),
            "proj": np.array([2.0, 5, 10])}


def test_evaluate_and_rows_match_jax(evaluators, poses):
    j_ev, t_ev = evaluators
    _, diameters, _, _ = poses
    # precondition of equal tables: no error sits on a threshold
    for obj, err in j_ev.compute_errors().items():
        thr = _thresholds(diameters[obj])
        for k in ("ad", "add", "adi", "re", "te", "proj"):
            e = err[k][np.isfinite(err[k])]
            if e.size:
                gap = np.abs(e[:, None] - thr[k if k in thr else "ad"]).min()
                assert gap > 1e-5, (obj, k, gap)
    j, t = j_ev.evaluate(), t_ev.evaluate()
    assert t == j
    assert 0 < t["mean"]["ad_10"] < 100 and 0 < t["mean"]["re_10"] < 100
    assert t_table(t) == j_table(j)
    obj2id = {"ape": 1, "can": 5, "eggbox": 10, "glue": 11}
    tr, jr = t_ev.bop_rows(obj2id), j_ev.bop_rows(obj2id)
    assert len(tr) == len(jr) == sum(N_PRED.values())
    for a, b in zip(tr, jr):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_score_functions_match_jax():
    rng = np.random.RandomState(3)
    per_obj_t, per_obj_j = {}, {}
    for obj in ("a", "b", "c"):
        err = [np.r_[rng.uniform(0, s, 40), np.inf] for s in
               (0.15, 20.0, 0.12, 30.0)]
        d = float(rng.uniform(0.1, 0.3))
        per_obj_t[obj] = tscore.pose_recalls(*err, d)
        per_obj_j[obj] = jscore.pose_recalls(*err, d)
        assert per_obj_t[obj] == per_obj_j[obj]
        for fn in ("auc_posecnn", "auc_voc"):
            assert getattr(tscore, fn)(err[0]) == getattr(jscore, fn)(err[0])
        assert tscore.recall_at(err[1], 5.0) == jscore.recall_at(err[1], 5.0)
    assert tscore.summarize_objects(per_obj_t) == \
        jscore.summarize_objects(per_obj_j)
    assert tscore.recall_at(np.zeros(0), 1.0) == 0.0


def test_recall_curves_match_jax(evaluators, poses, tmp_path):
    j_ev, _ = evaluators
    _, diameters, _, _ = poses
    errs = j_ev.compute_errors()
    jw = jplots.dump_recall_curves(errs, diameters, str(tmp_path / "j"),
                                   png=False)
    tw = tplots.dump_recall_curves(errs, diameters, str(tmp_path / "t"),
                                   png=False)
    assert [p.split("/")[-1] for p in tw] == [p.split("/")[-1] for p in jw]
    assert len(tw) == 6
    for a, b in zip(tw, jw):
        assert open(a, "rb").read() == open(b, "rb").read()
    raw = {"a": {"ad": np.array([0.001, 0.5])}}
    np.testing.assert_array_equal(
        tplots.recall_curve(raw["a"]["ad"], np.array([0.0, 0.01, 1.0]), 4),
        jplots.recall_curve(raw["a"]["ad"], np.array([0.0, 0.01, 1.0]), 4))


def _bop_inputs(seed):
    rng = np.random.RandomState(seed)
    B, S, N = 5, SYM[0].shape[0], 200
    pts = (rng.rand(B, N, 3) - 0.5) * 0.1
    R_gt = Rotation.random(B, random_state=seed).as_matrix()
    t_gt = np.c_[rng.uniform(-0.1, 0.1, (B, 2)), rng.uniform(0.6, 1, B)]
    R_est = _rotations(rng, B, 1, 30) @ R_gt
    t_est = t_gt + rng.randn(B, 3) * 0.02
    sym_r = np.broadcast_to(SYM[0], (B, S, 3, 3))
    sym_t = np.broadcast_to(SYM[1] + [0.0, 0.0, 0.004], (B, S, 3))
    Ks = np.broadcast_to(K, (B, 3, 3))
    return [np.ascontiguousarray(a, np.float32) for a in
            (R_est, t_est, R_gt, t_gt, pts, sym_r, sym_t, Ks)]


def test_mssd_mspd_match_jax():
    R_est, t_est, R_gt, t_gt, pts, sym_r, sym_t, Ks = _bop_inputs(2)
    T = [torch.from_numpy(a) for a in (R_est, t_est, R_gt, t_gt, pts, sym_r,
                                       sym_t, Ks)]
    for st in (None, sym_t):
        t_st = None if st is None else T[6]
        np.testing.assert_allclose(
            tbe.mssd(*T[:6], sym_trans=t_st).numpy(),
            np.asarray(jbe.mssd(R_est, t_est, R_gt, t_gt, pts, sym_r,
                                sym_trans=st)), rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            tbe.mspd(*T[:6], T[7], sym_trans=t_st).numpy(),
            np.asarray(jbe.mspd(R_est, t_est, R_gt, t_gt, pts, sym_r, Ks,
                                sym_trans=st)), rtol=0, atol=1e-3)
        for i in range(len(R_est)):
            a = (R_est[i], t_est[i], R_gt[i], t_gt[i], pts[i], sym_r[i])
            s = None if st is None else st[i]
            assert tbe.mssd_np(*a, sym_trans=s) == \
                jbe.mssd_np(*a, sym_trans=s)
            assert tbe.mspd_np(*a, Ks[i], sym_trans=s) == \
                jbe.mspd_np(*a, Ks[i], sym_trans=s)


def test_bop19_scoring_matches_jax():
    rng = np.random.RandomState(8)
    err = rng.uniform(0, 1, (6, 4))
    thr = rng.uniform(0.2, 0.8, (10, 4))
    assert tbs.match_poses_bop(err, thr[0]) == jbs.match_poses_bop(err,
                                                                   thr[0])
    np.testing.assert_array_equal(tbs.match_counts_batch(err, thr),
                                  jbs.match_counts_batch(err, thr))
    R_est, t_est, R_gt, t_gt, pts, sym_r, sym_t, _ = _bop_inputs(9)
    models = {1: pts[0], 5: pts[1]}
    banks = {1: sym_r[0], 5: sym_r[1]}
    trans = {1: sym_t[0], 5: sym_t[1]}
    gts, ests, targets = {}, [], []
    for i in range(len(R_est)):
        oid = 1 if i % 2 else 5
        key = (1, i // 2)
        gts.setdefault(key, []).append(
            {"obj_id": oid, "R": R_gt[i], "t": t_gt[i], "K": K})
        ests.append({"scene_id": 1, "im_id": i // 2, "obj_id": oid,
                     "score": float(rng.rand()), "R": R_est[i],
                     "t": t_est[i]})
        targets.append({"scene_id": 1, "im_id": i // 2, "obj_id": oid,
                        "inst_count": 1})
    targets.append({"scene_id": 1, "im_id": 9, "obj_id": 1,
                    "inst_count": 2})          # a target nobody estimated
    args = (ests, gts, targets, models, banks, {1: 0.12, 5: 0.09})
    t = tbs.bop19_average_recalls(*args, sym_trans=trans)
    j = jbs.bop19_average_recalls(*args, sym_trans=trans)
    assert t == j and set(t) == {"AR_mssd", "AR_mspd", "AR"}
    assert 0 < t["AR"] < 1
    # VSD's error fn renders on the port's host rasterizer, the JAX
    # package's on its own build: zero for the GT pose, within 1e-3 a tau
    # of each other for the estimates (tests/test_torch_vsd.py states why)
    from rdpn6d_tpu_torch.data.synthetic import cube_faces
    from rdpn6d_tpu_torch.ops.rasterizer import render_mesh

    v = np.array([[x, y, z] for x in (-0.05, 0.05) for y in (-0.05, 0.05)
                  for z in (-0.05, 0.05)], np.float32)
    mesh = {5: (v, cube_faces(v))}
    depth, _ = render_mesh(*mesh[5], K, R_gt[0], t_gt[0], 480, 640)
    fns = [m.make_vsd_error_fn(mesh, lambda s, i: depth, {5: 0.17})
           for m in (tbs, jbs)]
    gt = {"obj_id": 5, "R": R_gt[0], "t": t_gt[0], "K": K}
    exact = {"scene_id": 1, "im_id": 0, "R": R_gt[0], "t": t_gt[0]}
    assert fns[0](exact, gt).max() == 0.0
    for e in [exact] + ests[:3]:
        np.testing.assert_allclose(fns[0](e, gt), fns[1](e, gt), rtol=0,
                                   atol=1e-3)


def test_evaluator_runs_on_cuda_by_default(poses):
    models, diameters, _, _ = poses
    if torch.cuda.is_available():
        assert TEvaluator(models=models, diameters=diameters) \
            .device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TEvaluator(models=models, diameters=diameters)
