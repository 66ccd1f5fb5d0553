"""The slice end to end: RGB-D frames + detections -> served poses ->
ADD / ADI / re / te / proj, the port against the JAX package.

Both ``Predictor``s read the same ``params_pkl`` (flax trees as numpy) and
serve the same 480x640 frames in float32 (tiny config); their poses must
agree, and the port's pose errors on them must agree with
``rdpn6d_tpu.evaluation.pose_error``. Tolerance as in the model tests:
float32 sums in other orders through the crop, trunk and head, so rotations
to 1e-4 and translations to 1e-4 relative.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.data.assets import synthetic_class_assets as j_assets
from rdpn6d_tpu.data.pipeline import preprocess_roi as j_preprocess_roi
from rdpn6d_tpu.engine.predictor import Detection as JDet
from rdpn6d_tpu.engine.predictor import Predictor as JPredictor
from rdpn6d_tpu.evaluation import pose_error as jpe
from rdpn6d_tpu.models import RDPN as JRDPN
from rdpn6d_tpu.models import dummy_batch
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data import assets as tassets
from rdpn6d_tpu_torch.data.pipeline import preprocess_roi as t_preprocess_roi
from rdpn6d_tpu_torch.engine.predictor import Detection as TDet
from rdpn6d_tpu_torch.engine.predictor import Predictor as TPredictor
from rdpn6d_tpu_torch.evaluation import pose_error as tpe
from rdpn6d_tpu_torch.ops import cuda_build
from tests.test_torch_model import TINY, perturb

OPTS = TINY + ["backbone.rot_concat=true"]
K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
BOXES = [[200, 150, 330, 280.0], [300, 200, 420, 320.0],
         [5, 400, 120, 478.0], [560, 10, 640, 60.0]]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = JConfig().apply_opts(OPTS)
    variables = JRDPN(cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(3), dummy_batch(cfg, 1),
        train=False)
    params, stats = perturb(variables, 3)
    pkl = str(tmp_path_factory.mktemp("w") / "params.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"params": params, "batch_stats": stats}, f)
    rng = np.random.RandomState(0)
    rgb = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    depth = (0.8 + 0.1 * rng.rand(480, 640)).astype(np.float32)
    jp = JPredictor(cfg, j_assets(num_regions=4), params_pkl=pkl,
                    batch_size=3, dtype=jnp.float32)
    j_out = jp.predict(rgb, depth, K, [JDet(1, np.array(b)) for b in BOXES])
    tp = TPredictor(TConfig().apply_opts(OPTS),
                    tassets.synthetic_class_assets(num_regions=4),
                    params_pkl=pkl, batch_size=3, dtype=torch.float32,
                    device="cpu")
    t_out = tp.predict(rgb, depth, K, [TDet(1, np.array(b), 0.5)
                                       for b in BOXES])
    yield {"pkl": pkl, "rgb": rgb, "depth": depth, "j": j_out, "t": t_out}
    torch.set_num_threads(old)


def test_predictor_poses_match_jax(served):
    j_out, t_out = served["j"], served["t"]
    assert len(t_out) == len(j_out) == len(BOXES)
    for a, b in zip(t_out, j_out):
        assert a["obj_id"] == b["obj_id"] and a["score"] == 0.5
        np.testing.assert_allclose(a["R"], b["R"], atol=1e-4)
        np.testing.assert_allclose(a["t"], b["t"], rtol=1e-4,
                                   atol=1e-4 * np.abs(b["t"]).max())


def test_predictor_from_ckpt_dir_matches_jax(served, tmp_path):
    """``Predictor(ckpt_dir=...)``: the port's checkpoint of the same
    weights (``checkpoint_from_params_pkl``) serves the params_pkl
    Predictor's poses exactly, and so the JAX Predictor's within the
    tolerance above; a directory without a checkpoint is refused (the JAX
    Predictor's FileNotFoundError, ``rdpn6d_tpu/engine/predictor.py:78``)."""
    from rdpn6d_tpu_torch.utils.flax_params import checkpoint_from_params_pkl

    cfg = TConfig().apply_opts(OPTS)
    ckpt = str(tmp_path / "ckpt")
    checkpoint_from_params_pkl(cfg, served["pkl"], ckpt, step=4)
    tp = TPredictor(cfg, tassets.synthetic_class_assets(num_regions=4),
                    ckpt_dir=ckpt, batch_size=3, dtype=torch.float32,
                    device="cpu")
    out = tp.predict(served["rgb"], served["depth"], K,
                     [TDet(1, np.array(b), 0.5) for b in BOXES])
    for a, b in zip(out, served["t"]):
        np.testing.assert_array_equal(a["R"], b["R"])
        np.testing.assert_array_equal(a["t"], b["t"])
    empty = str(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        TPredictor(cfg, tassets.synthetic_class_assets(num_regions=4),
                   ckpt_dir=empty, device="cpu")


def test_preprocess_roi_matches_jax(served):
    """The eval crop of one ROI (uint8 rgb, depth_raw + factor)."""
    raw = (served["depth"] * 1000).astype(np.uint16)
    sample = {"rgb": served["rgb"], "depth_raw": raw,
              "depth_factor": np.float32(1000.0), "K": K,
              "bbox": np.array(BOXES[2], np.float32),
              "fps": np.zeros((4, 3), np.float32),
              "extent": np.ones(3, np.float32)}
    ref = j_preprocess_roi(JConfig().apply_opts(OPTS),
                           {k: jnp.asarray(v) for k, v in sample.items()},
                           jax.random.PRNGKey(0), train=False)
    out = t_preprocess_roi(TConfig().apply_opts(OPTS),
                           {k: torch.as_tensor(np.asarray(v))
                            for k, v in sample.items()})
    # the TPU path crops by matmul, the port by gather: sums in other
    # orders, ~1e-5 of the 0..1 pixels and ~1e-6 m of depth
    for k, tol in (("roi_img", 1e-5), ("roi_coord_2d", 1e-5),
                   ("bbox_center", 0), ("scale", 0), ("roi_wh", 0),
                   ("resize_ratio", 1e-7), ("roi_cam", 0)):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=tol, err_msg=k)


def test_pose_errors_match_jax(served):
    rng = np.random.RandomState(1)
    R_est = np.stack([r["R"] for r in served["t"]]).astype(np.float32)
    t_est = np.stack([r["t"] for r in served["t"]]).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(len(BOXES), 3, 3))
    R_gt = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    t_gt = (t_est + rng.normal(0, 0.01, t_est.shape)).astype(np.float32)
    t_gt[:, 2] = np.abs(t_gt[:, 2]) + 0.5
    t_est[:, 2] = np.abs(t_est[:, 2]) + 0.5
    pts = (rng.rand(len(BOXES), 700, 3) * 0.1 - 0.05).astype(np.float32)
    Kb = np.broadcast_to(K, (len(BOXES), 3, 3)).copy()
    T = [torch.from_numpy(x) for x in (R_est, t_est, R_gt, t_gt, pts, Kb)]
    J = [jnp.asarray(x) for x in (R_est, t_est, R_gt, t_gt, pts, Kb)]
    cuda_build.reset_launches()
    # adi: the JAX side takes the expanded-form XLA distance, the port the
    # direct form; per point ~1e-6 m at ~1 m from the camera
    pairs = [(tpe.add(*T[:5]), jpe.add(*J[:5]), 1e-6),
             (tpe.adi(*T[:5]), jpe.adi(*J[:5]), 2e-6),
             (tpe.re_deg(T[0], T[2]), jpe.re_deg(J[0], J[2]), 1e-3),
             (tpe.te(T[1], T[3]), jpe.te(J[1], J[3]), 1e-7),
             (tpe.proj_2d(*T), jpe.proj_2d(*J), 1e-3)]
    for ours, ref, atol in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=atol)
    # ... and the exact host scorer (scipy cKDTree)
    for i in range(len(BOXES)):
        assert abs(float(pairs[1][0][i]) - jpe.adi_np(
            R_est[i], t_est[i], R_gt[i], t_gt[i], pts[i])) < 1e-6
    # CPU tensors take the plain version: no kernel launch was counted
    assert cuda_build.LAUNCHES.get("min_dist2", 0) == 0


def test_predictor_refusals(served):
    cfg = TConfig().apply_opts(OPTS)
    assets = tassets.synthetic_class_assets(num_regions=4)
    with pytest.raises(ValueError, match="random-init"):
        TPredictor(cfg, assets, device="cpu")
    with pytest.raises(ValueError, match="trunk0..trunk3"):
        TPredictor(cfg.apply_opts(['test.int8="trunk5"']), assets,
                   device="cpu", allow_random_init=True)
    with pytest.raises(NotImplementedError):
        TPredictor(cfg.apply_opts(["test.use_pnp=true"]), assets,
                   device="cpu", allow_random_init=True)
    # a pkl made for another width does not cover the model
    with pytest.raises(ValueError, match="does not cover"):
        TPredictor(cfg.apply_opts(["backbone.depth=34"]), assets,
                   params_pkl=served["pkl"], device="cpu")
    tp = TPredictor(cfg, assets, device="cpu", allow_random_init=True,
                    dtype=torch.float32)
    assert tp.predict(served["rgb"], served["depth"], K, []) == []


def test_predictor_without_device_raises_on_cpu_machine():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPredictor(TConfig().apply_opts(OPTS),
                   tassets.synthetic_class_assets(num_regions=4),
                   allow_random_init=True)


def test_assets_match_jax():
    a = tassets.synthetic_class_assets(num_regions=8, num_pm_points=300)
    b = j_assets(num_regions=8, num_pm_points=300)
    for k in ("points", "extents", "fps_points", "sym_rots", "sym_trans",
              "diameters"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.obj_ids == b.obj_ids and a.full_idx(1) == b.full_idx(1)
