"""The RANSAC-Kabsch refinement (``test.use_pnp``) against the JAX
package's ``rdpn6d_tpu/ops/ransac_kabsch.py``: the two rigid fits, the
robust fit's plain version with JAX's own uniforms, the decode and the
batched refinement, the eval step with ``test.use_pnp`` on a tiny model with
the flax weights carried over, ``pnp_type="net"``, and ``run_eval`` with
``test.use_pnp`` on a synthetic LM tree.

The draws are inputs: JAX draws ``uniform(split(PRNGKey(0), b)[i], (H,
S))`` inside its step; the port takes a [B, H, S] table, into which these
tests put JAX's uniforms (over the batch size JAX pads to).

Tolerances: the plain version follows the JAX package op for op in float32
(the expanded d² in its order of terms, the same picks and argmaxes), so
the picks and best hypotheses are equal and R, t agree to 1e-5 (matmuls
and SVDs sum in other orders); ratios are ratios of equal integers, equal.
Through a network (the eval step, ``run_eval``) the inputs of the fit
already differ by ~1e-6, and the fit is held as the eval is (R, t within
1e-4; the per-object tables equal).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.models import dummy_batch
from rdpn6d_tpu.ops import ransac_kabsch as J
from rdpn6d_tpu.parallel import create_train_state as j_train_state
from rdpn6d_tpu.parallel import make_eval_step as j_eval_step
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.models import RDPN as TRDPN
from rdpn6d_tpu_torch.ops import cuda_build
from rdpn6d_tpu_torch.ops import ransac_kabsch as T
from rdpn6d_tpu_torch.parallel import make_eval_step as t_eval_step
from rdpn6d_tpu_torch.utils.flax_params import state_dict_from_flax
from tests.test_torch_eval_runner import OPTS as EVAL_OPTS
from tests.test_torch_eval_runner import _both, tree, weights  # noqa
from tests.test_torch_model import TINY, make_batch, perturb
from tests.test_torch_slice import served  # noqa

H, S = 128, 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def jax_uniforms(b, n=None):
    """JAX's hypothesis uniforms for a step over a batch of ``b`` ROIs,
    the first ``n`` of them."""
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    u = np.stack([np.asarray(jax.random.uniform(k, (H, S))) for k in keys])
    return u[:n]


def synth(B, N, seed, outliers=(0.0, 0.3, 0.6)):
    """Correspondences of a known pose (mm noise), outliers moved ~10 cm,
    85% of the mask set."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(B, 3, 3))
    R = q * np.sign(np.linalg.det(q))[:, None, None]
    t = np.stack([rng.uniform(-0.1, 0.1, B), rng.uniform(-0.1, 0.1, B),
                  rng.uniform(0.6, 1.2, B)], 1)
    m = rng.randn(B, N, 3) * 0.05
    c = np.einsum("bij,bnj->bni", R, m) + t[:, None] \
        + rng.randn(B, N, 3) * 0.001
    frac = np.asarray(outliers)[np.arange(B) % len(outliers)]
    out = rng.rand(B, N) < frac[:, None]
    c[out] += rng.randn(int(out.sum()), 3) * 0.1
    mask = (rng.rand(B, N) < 0.85).astype(np.float32)
    return m.astype(np.float32), c.astype(np.float32), mask, R, t


def jax_fit(m, c, mask, thr):
    """JAX's ``ransac_kabsch`` vmapped over ROIs with its keys, and its
    picks, fits and scores (``:139-165``, its code on the same draws)."""
    B = m.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    R, t, ratio = jax.vmap(lambda a, b, k, key: J.ransac_kabsch(
        a, b, k, key, inlier_thr=thr))(m, c, mask, keys)

    def internals(a, b, k, key):
        n = a.shape[0]
        cdf = jnp.cumsum(k.astype(jnp.float32))
        u = jax.random.uniform(key, (H, S)) * jnp.maximum(cdf[-1], 1.0)
        idx = jnp.clip(jnp.searchsorted(cdf, u), 0, n - 1)
        R_h, t_h = J.kabsch_quat(a[idx], b[idx])
        outer = (b[:, :, None] * a[:, None, :]).reshape(n, 9)
        d2 = (jnp.sum(a * a, -1)[None] + jnp.sum(b * b, -1)[None]
              + jnp.sum(t_h * t_h, -1)[:, None]
              + 2.0 * (jnp.einsum("hji,hj->hi", R_h, t_h) @ a.T)
              - 2.0 * (R_h.reshape(H, 9) @ outer.T)
              - 2.0 * (t_h @ b.T))
        score = jnp.sum((d2 < thr * thr) & (k[None] > 0), -1)
        return idx, R_h, t_h, score

    idx, R_h, t_h, score = jax.vmap(internals)(m, c, mask, keys)
    return [np.asarray(x) for x in (R, t, ratio, idx, R_h, t_h, score)]


def t_fit(m, c, mask, thr):
    return T.ransac_kabsch(*(torch.from_numpy(x) for x in (m, c, mask)),
                           torch.from_numpy(jax_uniforms(m.shape[0])), thr)


def test_kabsch_and_kabsch_quat_match_jax():
    m, c, mask, R_true, t_true = synth(6, 40, 0, outliers=(0.0,))
    w = np.random.RandomState(1).rand(6, 40).astype(np.float32)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.from_numpy(weights)
        for jf, tf in ((J.kabsch, T.kabsch), (J.kabsch_quat, T.kabsch_quat)):
            jR, jt = jf(jnp.asarray(m), jnp.asarray(c), jw)
            tR, tt = tf(torch.from_numpy(m), torch.from_numpy(c), tw)
            np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
            np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
            np.testing.assert_allclose(tR.numpy(), R_true, atol=1e-2)


@pytest.mark.parametrize("thr", [0.01, 0.015])
def test_ransac_plain_matches_jax(thr):
    m, c, mask, R_true, _ = synth(6, 1024, 2)
    jR, jt, jratio, jidx, jRh, jth, score = jax_fit(m, c, mask, thr)
    u = torch.from_numpy(jax_uniforms(6))
    picks = T.hypothesis_picks(torch.from_numpy(mask), u)
    np.testing.assert_array_equal(picks.numpy(), jidx)
    src = torch.take_along_dim(torch.from_numpy(m), picks.reshape(6, -1, 1),
                               1).reshape(6, H, S, 3)
    dst = torch.take_along_dim(torch.from_numpy(c), picks.reshape(6, -1, 1),
                               1).reshape(6, H, S, 3)
    Rh, th = T.kabsch_quat(src, dst)
    np.testing.assert_allclose(Rh.numpy(), jRh, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), jth, atol=1e-5)
    fit = t_fit(m, c, mask, thr)
    np.testing.assert_array_equal(fit.best.numpy(), score.argmax(-1))
    np.testing.assert_array_equal(fit.score.numpy(), score.max(-1))
    np.testing.assert_array_equal(fit.ratio.numpy(), jratio)
    np.testing.assert_allclose(fit.R.numpy(), jR, atol=1e-5)
    np.testing.assert_allclose(fit.t.numpy(), jt, atol=1e-5)
    # every ROI but the 60%-outlier ones lands on its true pose
    assert np.abs(fit.R.numpy() - R_true)[::3].max() < 5e-3


def test_ransac_degenerate_rois_match_jax():
    """An all-masked ROI (every pick the last point, a zero covariance:
    R = I), one with 3 valid points (fewer inliers than a sample: the mask
    refit), and a NaN point (its weight 0, yet NaN * 0 makes the refit NaN,
    as in JAX), on the plain version and on JAX."""
    m, c, mask, _, _ = synth(4, 100, 3, outliers=(0.0,))
    mask[0] = 0.0
    mask[1] = 0.0
    mask[1, [4, 40, 77]] = 1.0
    m[2, 50, 1] = np.nan
    mask[2, 50] = 0.0
    jR, jt, jratio, jidx, _, _, _ = jax_fit(m, c, mask, 0.01)
    fit = t_fit(m, c, mask, 0.01)
    np.testing.assert_array_equal(
        T.hypothesis_picks(torch.from_numpy(mask),
                           torch.from_numpy(jax_uniforms(4))).numpy(), jidx)
    np.testing.assert_array_equal(fit.ratio.numpy(), jratio)
    assert np.isnan(jR[2]).all() and np.isnan(jt[2]).all()
    assert fit.R[2].isnan().all() and fit.t[2].isnan().all()
    for i in (0, 1, 3):
        np.testing.assert_allclose(fit.R[i].numpy(), jR[i], atol=1e-5)
        np.testing.assert_allclose(fit.t[i].numpy(), jt[i], atol=1e-5)
    np.testing.assert_allclose(fit.R[0].numpy(), np.eye(3), atol=1e-6)
    assert float(fit.ratio[0]) == 0.0 and int(fit.score[1]) <= 3


def test_ransac_routing_and_refusals():
    m, c, mask, _, _ = synth(2, 64, 4)
    args = [torch.from_numpy(x) for x in (m, c, mask)] \
        + [T.hypothesis_draws(2, H, S)]
    cuda_build.reset_launches()
    got = T.ransac_kabsch(*args)
    ref = T.ransac_kabsch_plain(*args)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert cuda_build.LAUNCHES.get("ransac_kabsch", 0) == 0
    with pytest.raises(TypeError, match="float32"):
        T.ransac_kabsch(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="expected"):
        T.ransac_kabsch(args[0][:, :10], *args[1:])
    with pytest.raises(ValueError, match="no kernel"):
        T.ransac_kabsch(*(a.to("meta") for a in args))


def test_hypothesis_draws_are_one_table_per_size():
    a = T.hypothesis_draws(3, H, S)
    assert a.shape == (3, H, S) and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert torch.equal(T.hypothesis_draws(3, H, S), a)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(a, torch.rand((3, H, S), generator=g))
    assert torch.equal(T.hypothesis_draws(3, H, S, "cpu"), a)


def scene(B, seed):
    """Head outputs whose decode gives points on an object seen at a known
    pose: coord from the true model points through the net rotation, the
    depth crop's xyz from the true pose, a mask probability of 0.9 on the
    object (a few pixels off it, and some at z = 0), region logits picking
    each pixel's nearest keypoint."""
    rng = np.random.RandomState(seed)
    Hh = W = 16
    K = 4
    q, _ = np.linalg.qr(rng.randn(2 * B, 3, 3))
    q = q * np.sign(np.linalg.det(q))[:, None, None]
    R_true, R_net = q[:B], q[B:]
    t_true = np.stack([rng.uniform(-0.1, 0.1, B), rng.uniform(-0.1, 0.1, B),
                       rng.uniform(0.6, 1.2, B)], 1)
    extent = rng.uniform(0.06, 0.2, (B, 3))
    fps = (rng.rand(B, K, 3) - 0.5) * extent[:, None]
    m = (rng.rand(B, Hh, W, 3) - 0.5) * extent[:, None, None]
    ids = ((m[:, :, :, None] - fps[:, None, None]) ** 2).sum(-1).argmin(-1)
    region = rng.randn(B, Hh, W, K + 1)
    region[..., 1:] += 10.0 * np.eye(K)[ids]
    fps_sel = np.take_along_axis(fps[:, None, None], ids[..., None, None],
                                 3)[..., 0, :]
    coord = 0.5 + np.einsum("bij,bhwj->bhwi", R_net, m - fps_sel) \
        / extent[:, None, None]
    cam = np.einsum("bij,bhwj->bhwi", R_true, m) + t_true[:, None, None]
    cam += rng.randn(*cam.shape) * 0.001
    ratio = rng.uniform(0.3, 0.6, B)
    depth_xyz = cam / ratio[:, None, None, None]
    prob = np.where(rng.rand(B, Hh, W) < 0.9, 0.9, 0.1)
    depth_xyz[:, :2, :, 2] = 0.0           # no depth at the top rows
    trans_net = t_true + 0.05
    f = np.float32
    return [x.astype(f) for x in (coord, region, prob, depth_xyz, ratio, fps,
                                  extent, R_net, trans_net)], R_true, t_true


def test_decode_and_refine_match_jax():
    (coord, region, prob, depth_xyz, ratio, fps, extent, R_net,
     trans_net), R_true, t_true = scene(5, 6)
    # ROI 4 without a valid pixel: the net pose stands
    prob[4] = 0.0
    dec = T.decode_model_coords(*(torch.from_numpy(x) for x in (
        coord, region, fps, extent, R_net)))
    jdec = jax.vmap(J.decode_model_coords)(coord, region, fps, extent, R_net)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=1e-6)
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    jR, jt, jratio = jax.vmap(lambda *a: J.refine_pose_kabsch(
        *a, mask_thr=0.5))(coord, region, prob, depth_xyz, ratio, fps,
                           extent, R_net, trans_net, keys)
    out = T.refine_pose_kabsch(*(torch.from_numpy(x) for x in (
        coord, region, prob, depth_xyz, ratio, fps, extent, R_net,
        trans_net)), torch.from_numpy(jax_uniforms(5)), mask_thr=0.5)
    np.testing.assert_array_equal(out.ratio.numpy(), np.asarray(jratio))
    np.testing.assert_allclose(out.R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(jt), atol=1e-5)
    assert (out.ratio[:4] > 0.5).all() and float(out.ratio[4]) == 0.0
    np.testing.assert_allclose(out.R[:4].numpy(), R_true[:4], atol=5e-3)
    np.testing.assert_allclose(out.t[:4].numpy(), t_true[:4], atol=5e-3)
    np.testing.assert_array_equal(out.R[4].numpy(), R_net[4])
    np.testing.assert_array_equal(out.t[4].numpy(), trans_net[4])


def _tiny(opts, B=3):
    """The tiny model's perturbed flax variables and both packages' models
    on them, and a batch whose depth crop (not a network input without
    ``pnp.with_2d_coord``) holds, for ROIs 0 and 1, the points that the
    JAX model's own outputs decode to, seen at a known pose (the
    refinement finds it), and for ROI 2 points strewn through a metre
    cube (it finds nothing: the net pose stands)."""
    jcfg, tcfg = JConfig().apply_opts(opts), TConfig().apply_opts(opts)
    jmodel = JRDPN(jcfg, dtype=jnp.float32)
    variables = jax.jit(lambda key: jmodel.init(
        key, dummy_batch(jcfg, 1), train=False))(jax.random.PRNGKey(3))
    params, stats = perturb(variables, 3)
    batch = make_batch(jcfg, B, seed=8)
    out = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        {"params": params, "batch_stats": stats},
        {k: jnp.asarray(v) for k, v in batch.items()})
    m = np.asarray(jax.vmap(J.decode_model_coords)(
        out["coord"], out["region_logits"], batch["fps"],
        batch["roi_extent"], out["rot_ego"]))
    rng = np.random.RandomState(9)
    q, _ = np.linalg.qr(rng.randn(B, 3, 3))
    R_true = q * np.sign(np.linalg.det(q))[:, None, None]
    cam = np.einsum("bij,bhwj->bhwi", R_true, m) \
        + np.array([0.02, -0.03, 0.9]) + rng.randn(*m.shape) * 5e-4
    cam[2] = rng.rand(*cam.shape[1:]) + np.array([-0.5, -0.5, 0.5])
    batch["roi_coord_2d"][..., :3] = cam / batch["resize_ratio"][
        :, None, None, None]
    model = TRDPN(tcfg)
    model.load_state_dict(state_dict_from_flax(tcfg, params, stats))
    model.eval()
    state = j_train_state(jcfg, {"params": params, "batch_stats": stats},
                          optax.identity())
    return jcfg, tcfg, state, model, batch


@pytest.mark.parametrize("pnp_type", ["ransac_kabsch", "net"])
def test_eval_step_matches_jax(pnp_type, monkeypatch):
    opts = TINY + ["test.use_pnp=true", f'test.pnp_type="{pnp_type}"',
                   'head.mask_loss="BCE"', "pnp.with_2d_coord=false"]
    jcfg, tcfg, state, model, batch = _tiny(opts)
    monkeypatch.setattr(T, "hypothesis_draws",
                        lambda b, h, s, device: torch.from_numpy(
                            jax_uniforms(b)).to(device))
    j = j_eval_step(jcfg, JRDPN(jcfg, dtype=jnp.float32))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    t = t_eval_step(tcfg, model)({k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert ("inlier_ratio" in t) == ("inlier_ratio" in j) \
        == (pnp_type == "ransac_kabsch")
    for k in ("mask_prob", "coord", "region_logits"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(t["rot_ego"].numpy(), np.asarray(j["rot_ego"]),
                               atol=1e-4)
    np.testing.assert_allclose(t["trans"].numpy(), np.asarray(j["trans"]),
                               rtol=1e-4)
    net = t_eval_step(tcfg.apply_opts(["test.use_pnp=false"]), model)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    if pnp_type == "net":
        assert torch.equal(t["rot_ego"], net["rot_ego"])
        return
    np.testing.assert_array_equal(t["inlier_ratio"].numpy(),
                                  np.asarray(j["inlier_ratio"]))
    refined = t["inlier_ratio"] > T.REFINE_MIN_RATIO
    kept = (t["rot_ego"] == net["rot_ego"]).flatten(1).all(1)
    assert refined.tolist() == [True, True, False]
    assert torch.equal(kept, ~refined)


def test_run_eval_use_pnp_matches_jax(tree, weights, tmp_path,  # noqa
                                      monkeypatch):
    """The slice as a whole: ``run_eval`` with ``test.use_pnp`` on the LM
    tree, the JAX package's draws injected (its batches are padded to 2
    ROIs, so its keys split over 2), against the JAX ``run_eval``: the CSV
    within 1e-4, the per-object tables equal. The tiny seeded weights
    decode little geometry the depth agrees with: every ROI is fitted,
    one of the 6 clears the 0.05 inlier ratio and takes the refit."""
    monkeypatch.setattr(T, "hypothesis_draws",
                        lambda b, h, s, device: torch.from_numpy(
                            jax_uniforms(2, b)).to(device))
    ratios = []
    refine = T.refine_pose_kabsch

    def recording(*a, **kw):
        out = refine(*a, **kw)
        ratios.extend(out.ratio.tolist())
        return out

    monkeypatch.setattr(T, "refine_pose_kabsch", recording)
    j, t = _both(tree, weights, tmp_path, monkeypatch, "two_obj_test",
                 ["test.use_pnp=true"])
    assert len(ratios) == t["stats"]["n_rois"] == 6
    assert sum(r > T.REFINE_MIN_RATIO for r in ratios) == 1
    assert set(t["per_obj"]) == {"ape", "can"}


def test_predictor_use_pnp_matches_jax(served, monkeypatch):
    """``Predictor.predict`` with ``test.use_pnp`` against the JAX
    ``Predictor`` on the same weights, frame and 4 boxes in batches of 3:
    JAX pads the second batch to 3 by repeating its last box, so its keys
    split over 3 in both batches, and the port's draws are JAX's first
    rows. Poses within the slice's 1e-4."""
    from rdpn6d_tpu.data.assets import synthetic_class_assets as j_assets
    from rdpn6d_tpu.engine.predictor import Detection as JDet
    from rdpn6d_tpu.engine.predictor import Predictor as JPredictor
    from rdpn6d_tpu_torch.data import assets as tassets
    from rdpn6d_tpu_torch.engine.predictor import Detection as TDet
    from rdpn6d_tpu_torch.engine.predictor import Predictor as TPredictor
    from tests.test_torch_slice import BOXES, K
    from tests.test_torch_slice import OPTS as SLICE_OPTS

    opts = SLICE_OPTS + ["test.use_pnp=true"]
    monkeypatch.setattr(T, "hypothesis_draws",
                        lambda b, h, s, device: torch.from_numpy(
                            jax_uniforms(3, b)).to(device))
    fits = []
    refine = T.refine_pose_kabsch

    def recording(*a, **kw):
        out = refine(*a, **kw)
        fits.append(out)
        return out

    monkeypatch.setattr(T, "refine_pose_kabsch", recording)
    jp = JPredictor(JConfig().apply_opts(opts), j_assets(num_regions=4),
                    params_pkl=served["pkl"], batch_size=3,
                    dtype=jnp.float32)
    j = jp.predict(served["rgb"], served["depth"], K,
                   [JDet(1, np.array(b)) for b in BOXES])
    tp = TPredictor(TConfig().apply_opts(opts),
                    tassets.synthetic_class_assets(num_regions=4),
                    params_pkl=served["pkl"], batch_size=3,
                    dtype=torch.float32, device="cpu")
    t = tp.predict(served["rgb"], served["depth"], K,
                   [TDet(1, np.array(b)) for b in BOXES])
    assert [f.R.shape[0] for f in fits] == [3, 1]
    for a, b in zip(t, j):
        np.testing.assert_allclose(a["R"], np.asarray(b["R"]), atol=1e-4)
        np.testing.assert_allclose(a["t"], np.asarray(b["t"]), rtol=1e-4)


def test_kernel_limits_match_the_source():
    """The wrapper's copies of the kernel's constants are the source's,
    and a launch the kernel would refuse is refused before it, by name."""
    import re

    src = open(os.path.join(os.path.dirname(T.__file__), os.pardir, "csrc",
                            "ransac_kabsch.cu")).read()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kTile"], consts["kMaxSample"], consts["kMaxSmem"],
            consts["kMaxCluster"]) \
        == (T.TILE, T.MAX_SAMPLE, T.MAX_SMEM, max(T.CLUSTER_SIZES))
    body = re.search(r"smem_bytes\(int N, int H, int S, int C\) \{(.*?)\n\}",
                     src, re.S).group(1)
    assert " ".join(body.replace("(size_t)", "").split()) == (
        "const int tiles = (N + kTile - 1) / kTile; const int pmax = "
        "(tiles + C - 1) / C * kTile; const int nh = (H + C - 1) / C; "
        "return 4 * (8 * pmax + 12 * H + (C + 1) * H + 6 * nh * S + "
        "16 * tiles);")
    # one tile a block at 16 blocks; 4096 points staged in one block
    assert T.shared_bytes(4096, 128, 4, 16) \
        == 4 * (8 * 256 + 12 * 128 + 17 * 128 + 6 * 8 * 4 + 16 * 16)
    assert T.shared_bytes(4096, 128, 4, 1) \
        == 4 * (8 * 4096 + 12 * 128 + 2 * 128 + 6 * 128 * 4 + 16 * 16)
    assert T.shared_bytes(100, 128, 4, 16) \
        == 4 * (8 * 256 + 12 * 128 + 17 * 128 + 6 * 8 * 4 + 16)
    # 9000 points (36 tiles) do not fit one block, so two at least
    assert T.cluster_sizes(9000, 128, 4) == (2, 4, 8, 16)
    assert T.cluster_sizes(4096, 128, 4) == T.CLUSTER_SIZES
    m, c, mask, _, _ = synth(1, 64, 5)
    args = [torch.from_numpy(x) for x in (m, c, mask)]
    with pytest.raises(ValueError, match="at most 16"):
        T._launch(*args, torch.rand(1, 128, 17), 0.01)
    with pytest.raises(ValueError, match="at most 16"):
        T._launch(*args, torch.rand(1, 4000, 4), 0.01)



# clusters an H100 SXM holds at one block an SM (cluster_slots on the card)
H100_SLOTS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


@pytest.mark.parametrize("sms", [132, 114])
def test_cluster_blocks_cover_the_sms(sms):
    """The blocks of a ROI's cluster on a card whose SMs all take part: a
    power of two in [1, 16], the largest with B x C <= the SM count (so
    every cluster is resident at once), 1 at B >= the SM count; within the
    sizes a launch fits. On an H100 SXM, whose GPCs hold fewer clusters of
    8 and 16 than that, the largest C whose B clusters it holds."""
    slots = {c: sms // c for c in T.CLUSTER_SIZES}
    for B in range(1, 3 * sms):
        C = T.cluster_blocks(B, slots)
        assert C in (1, 2, 4, 8, 16)
        if B * 16 <= sms:
            assert C == 16
        elif B <= sms:
            assert B * C <= sms < 2 * B * C
        else:
            assert C == 1
        # 9000 points need two blocks at least: never fewer
        assert T.cluster_blocks(B, slots, (2, 4, 8, 16)) == max(C, 2)
        Ch = T.cluster_blocks(B, H100_SLOTS)
        assert Ch == max([c for c in T.CLUSTER_SIZES
                          if B <= H100_SLOTS[c]], default=1)
        assert B * Ch <= 132 or Ch == 1
    assert [T.cluster_blocks(B, {c: 132 // c for c in T.CLUSTER_SIZES})
            for B in (6, 8, 16, 32, 64, 132, 200)] == [16, 16, 8, 4, 2, 1, 1]
    assert [T.cluster_blocks(B, H100_SLOTS)
            for B in (6, 8, 16, 32, 64, 67, 200)] == [16, 8, 4, 2, 2, 1, 1]


def cluster_picks(mask, u, C):
    """The kernel's scan and sample (``csrc/ransac_kabsch.cu``, stages 1
    and 2) for one ROI, rank by rank: each rank's tiles, its cdf offset by
    the lower ranks' totals, the rank that holds each pick and its search
    of its own slice. Also checks that the ranks' points cover [0, N) once
    within each block's staging room, and that the rank fitting each
    hypothesis is the one whose share holds it."""
    N = mask.shape[0]
    H, S = u.shape
    tiles = -(-N // T.TILE)

    def start(r, n):
        return (r * n + C - 1) // C

    lo = [min(start(r, tiles) * T.TILE, N) for r in range(C + 1)]
    assert lo[0] == 0 and lo[C] == N and all(
        0 <= lo[r + 1] - lo[r] <= -(-tiles // C) * T.TILE for r in range(C))
    cdfs = []
    for r in range(C):
        cdf = np.cumsum(mask[lo[r]:lo[r + 1]], dtype=np.float32)
        cdfs.append(cdf)
    incl = np.cumsum([c[-1] if len(c) else np.float32(0) for c in cdfs],
                     dtype=np.float32)
    scale = np.float32(max(incl[-1], np.float32(1)))
    picks = np.empty((H, S), np.int64)
    for h in range(H):
        f = h * C // H
        assert start(f, H) <= h < start(f + 1, H)
        for s in range(S):
            uu = np.float32(u[h, s] * scale)
            owner = 0
            while owner < C and incl[owner] < uu:
                owner += 1
            if owner == C:
                picks[h, s] = N - 1
                last = (N - 1) // T.TILE * C // tiles
                assert lo[last] <= N - 1 < lo[last + 1]
                continue
            cdf = cdfs[owner] + (incl[owner - 1] if owner else np.float32(0))
            i = int(np.searchsorted(cdf, uu, "left"))
            assert i < len(cdf)
            picks[h, s] = lo[owner] + i
    return picks


@pytest.mark.parametrize("N", [100, 4096, 4097, 9000])
@pytest.mark.parametrize("kind", ["85%", "3 valid", "none"])
def test_cluster_split_picks_as_one_block(N, kind):
    """Split over any cluster size, the kernel's scan and sample pick what
    the parent's one block picked, which is ``hypothesis_picks``: for a
    0/1 mask every cdf value is an exact integer, however it is summed."""
    rng = np.random.RandomState(N)
    mask = (rng.rand(N) < 0.85).astype(np.float32)
    if kind == "3 valid":
        mask[:] = 0.0
        mask[rng.choice(N, 3, replace=False)] = 1.0
    elif kind == "none":
        mask[:] = 0.0
    u = rng.rand(H, S).astype(np.float32)
    u[0, 0] = 0.0
    want = T.hypothesis_picks(torch.from_numpy(mask)[None],
                              torch.from_numpy(u)[None])[0].numpy()
    for C in T.CLUSTER_SIZES:
        np.testing.assert_array_equal(cluster_picks(mask, u, C), want)

def test_main_runs_the_variants_with_use_pnp(tree, tmp_path,  # noqa
                                             monkeypatch):
    """``main`` on the CPU with the s2d stem, PointPnP (the mask
    concatenated as a channel) and ``pnp.r_only``: 3 flat train steps and
    a checkpoint, then ``--eval-only`` with ``test.use_pnp`` on it, one
    refinement an eval batch and a pose for each of the 6 instances; and
    int8-head-static serving with ``test.use_pnp`` (the refinement after
    the calibrated model, as in the JAX package)."""
    from rdpn6d_tpu_torch import main as tmain
    from rdpn6d_tpu_torch.data import assets as tassets
    from rdpn6d_tpu_torch.engine.predictor import Detection, Predictor

    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    calls = []
    refine = T.refine_pose_kabsch

    def recording(*a, **kw):
        out = refine(*a, **kw)
        calls.append(out.R.shape[0])
        return out

    monkeypatch.setattr(T, "refine_pose_kabsch", recording)
    variant = ["backbone.space_to_depth=true", 'pnp.pnp_head="PointPnP"',
               "pnp.r_only=true", 'head.mask_loss="BCE"',
               'pnp.mask_attention="concat"']
    out = tmp_path / "run"
    base = ["--config-file", "rdpn6d_tpu_torch/configs/lm13.py",
            "--device", "cpu", "--opts", *EVAL_OPTS, *variant,
            'backbone.pretrained=""', f'train.output_dir="{out}"']
    train = ["data.grouped_train=false",
             'data.train_datasets=["two_obj_test"]',
             "solver.ims_per_batch=2", "solver.total_epochs=1",
             "train.eval_period=0"]
    assert tmain.main(base + train).step == 3
    res = tmain.main(base[:1] + base[1:2] + ["--eval-only"] + base[2:]
                     + ["test.use_pnp=true",
                        'data.test_datasets=["two_obj_test"]'])
    assert res["two_obj_test"]["stats"]["n_rois"] == 6
    assert calls == [6]        # main's eval batch holds all 6
    calls.clear()
    cfg = TConfig().apply_opts(EVAL_OPTS + [
        "test.use_pnp=true", 'test.int8="head"', "test.int8_static=true"])
    pred = Predictor(cfg, tassets.synthetic_class_assets(num_regions=4),
                     batch_size=3, dtype=torch.float32, device="cpu",
                     allow_random_init=True)
    rng = np.random.RandomState(0)
    rgb = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    depth = (0.8 + 0.1 * rng.rand(480, 640)).astype(np.float32)
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                 np.float32)
    got = pred.predict(rgb, depth, K, [
        Detection(1, np.array([100 + 40 * i, 120, 220 + 40 * i, 260.0]))
        for i in range(4)])
    assert calls == [3, 1] and not pred._needs_calibration
    assert all(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all()
               for r in got)
