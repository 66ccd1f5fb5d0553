"""Colour augmentation of the port against ``rdpn6d_tpu.data.augment``.

The port takes its draws as an input; these tests take the JAX package's
by repeating its key splits (``color_augment``: one key an op; each op's
key split into its on-flag's and its value's; ``_channel_value``'s three;
the invert flip's first half) and feed them to the port. Images are
float32 in 0..255 from a numpy seed.

Tolerance: 1e-3 on the 0..255 scale for every op and pipeline on the same
input (float32 sums in other orders: the blur's 7 taps, the gray mean,
the lighting's 3x3 products). ``lighting`` is held up to the sign of each
eigenvector of the colour covariance, which the math leaves free: the JAX
package keeps LAPACK's, which flips under a rounding of the covariance
(it does for one of these images), the port makes each eigenvector's
largest component positive. A flipped eigenvector equals a flipped noise
component, so the test feeds the port the JAX draw times the sign that
maps one basis onto the other. On the card the port's convention holds
too, so the card equals the CPU to rounding (``test_torch_cuda.py``).

Through ``preprocess_rois_grouped(train=True)`` with the JAX package's DZI
boxes and draws injected, ``roi_img``'s RGB (normalized by 255) agrees to
2e-4: the crops alone differ by up to 5e-5 (an FMA on the JAX side, see
``test_torch_train_labels.py``), and the ops multiply a difference by at
most 1.4 x 1.4 x 2.2 = 4.3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.data import augment as jaug
from rdpn6d_tpu.data.pipeline import preprocess_rois_grouped as j_grouped
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data import augment as taug
from rdpn6d_tpu_torch.data import synthetic as tsyn
from rdpn6d_tpu_torch.data.pipeline import preprocess_rois_grouped as t_grouped

TOL = 1e-3
NAMES = ["code", "aae", "aae_weak", "lm", "roi10d", "none"]
TINY = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax_op(op):
    return jaug.AugOp(**dataclasses.asdict(op))


def jax_draws(key, ops, size):
    """The draws ``jaug.color_augment(img, key, ops)`` makes for an image
    of ``size``, in the port's layout (unbatched)."""
    out = []
    for op, k in zip(ops, jax.random.split(key, len(ops))):
        kp, kv = jax.random.split(k)
        on = jax.random.bernoulli(kp, op.prob)
        if op.kind in ("blur", "saturation", "brightness_mul",
                       "contrast_gray"):
            v = jax.random.uniform(kv, (), minval=op.lo, maxval=op.hi)
        elif op.kind in ("add", "multiply", "contrast"):
            k1, k2, k3 = jax.random.split(kv, 3)
            per = jax.random.bernoulli(k1, op.per_channel)
            v = jnp.where(per, jax.random.uniform(k2, (3,), minval=op.lo,
                                                  maxval=op.hi),
                          jax.random.uniform(k3, (), minval=op.lo,
                                             maxval=op.hi))
        elif op.kind == "invert":
            k1, _ = jax.random.split(kv)
            v = jax.random.bernoulli(k1, op.lo, (3,))
        elif op.kind == "dropout":
            v = jax.random.bernoulli(kv, op.lo,
                                     taug.dropout_grid_size(op, size))
        else:
            v = jax.random.normal(kv, (3,)) * op.lo
        out.append({"on": np.asarray(on), "value": np.asarray(v)})
    return out


def lighting_signs(img):
    """Per eigenvector, +1 or -1: the port's eigenvector over the JAX
    package's (both of the image's colour covariance)."""
    flat = img.reshape(-1, 3) / 255.0
    _, jv = jnp.linalg.eigh(jnp.cov(jnp.asarray(flat), rowvar=False))
    cov = np.cov(flat.astype(np.float64), rowvar=False)
    tv = np.linalg.eigh(cov)[1]
    tv = tv * np.sign(tv[np.abs(tv).argmax(0), range(3)])
    return np.sign((tv * np.asarray(jv)).sum(0)).astype(np.float32)


def batch_draws(per_roi):
    """Per-ROI draws -> the port's batched params."""
    return [{k: torch.from_numpy(np.stack([d[i][k] for d in per_roi]))
             for k in ("on", "value")} for i in range(len(per_roi[0]))]


def _images(seed, n, h=20, w=28):
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    img[:, :3] = 0.0                      # saturated rows: the clip and
    img[:, -2:, :5] = 255.0               # the edge padding matter
    return img


@pytest.mark.parametrize("name", NAMES)
def test_pipelines_match_jax(name):
    t_ops = taug.get_aug_pipeline(name)
    assert [dataclasses.asdict(o) for o in t_ops] == \
        [dataclasses.asdict(o) for o in jaug.get_aug_pipeline(name)]
    with pytest.raises(ValueError, match="unknown"):
        taug.get_aug_pipeline("imgaug")
    assert taug.config_ops((), name) == t_ops
    custom = ({"kind": "add", "prob": 1.0, "lo": 1.0, "hi": 2.0},)
    assert taug.config_ops(custom, name) == (taug.AugOp("add", 1.0, 1.0,
                                                        2.0),)


_ALL_OPS = {(op.kind, op.per_channel): op
            for name in NAMES for op in taug.get_aug_pipeline(name)}


@pytest.mark.parametrize("key", sorted(_ALL_OPS),
                         ids=lambda k: f"{k[0]}-pc{k[1]}")
def test_each_op_matches_jax(key):
    """Each distinct op, forced on and at its own probability, over 6
    seeds of draws (per-channel and shared values both occur)."""
    base = _ALL_OPS[key]
    imgs = _images(1, 6)
    for op in (dataclasses.replace(base, prob=1.0), base):
        draws = [jax_draws(jax.random.PRNGKey(s), (op,), imgs.shape[1:3])
                 for s in range(len(imgs))]
        if op.kind == "lighting":
            for d, im in zip(draws, imgs):
                d[0]["value"] = d[0]["value"] * lighting_signs(im)
        want = np.stack([np.asarray(jaug.color_augment(
            jnp.asarray(im), jax.random.PRNGKey(s), (_jax_op(op),)))
            for s, im in enumerate(imgs)])
        got = taug.color_augment(torch.from_numpy(imgs), batch_draws(draws),
                                 (op,)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                   err_msg=str(op))
        if op.prob == 1.0 and op.kind != "invert":
            assert not np.array_equal(got, imgs), "the op changed nothing"


@pytest.mark.parametrize("name", NAMES)
def test_named_pipeline_batched_matches_jax(name):
    """B ROIs in one call against one JAX call a ROI, each ROI its key."""
    ops = taug.get_aug_pipeline(name)
    j_ops = tuple(_jax_op(o) for o in ops)
    imgs = _images(2, 5)
    keys = [jax.random.PRNGKey(100 + i) for i in range(len(imgs))]
    want = np.stack([np.asarray(jaug.color_augment(jnp.asarray(im), k, j_ops))
                     for im, k in zip(imgs, keys)])
    draws = [jax_draws(k, ops, imgs.shape[1:3]) for k in keys]
    for d, k, im in zip(draws, keys, imgs):
        if name == "roi10d":            # lighting runs last, on this image
            before = jaug.color_augment(jnp.asarray(im), k, j_ops[:-1])
            d[-1]["value"] = d[-1]["value"] * lighting_signs(
                np.asarray(before))
    got = taug.color_augment(torch.from_numpy(imgs), batch_draws(draws),
                             ops).numpy() if ops else imgs
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_draws_shapes_and_rates():
    """The port's own draws: shapes, dtypes, and each op's on-rate near its
    probability over 4000 ROIs (a binomial 5-sigma bound)."""
    ops = taug.get_aug_pipeline("aae") + taug.get_aug_pipeline("roi10d")
    g = torch.Generator().manual_seed(0)
    n = 4000
    params = taug.draw_aug_params(ops, n, g, size=(40, 60))
    for op, p in zip(ops, params):
        rate = p["on"].float().mean().item()
        assert abs(rate - op.prob) <= 5 * np.sqrt(op.prob * (1 - op.prob)
                                                  / n) + 1e-9, op
        v = p["value"]
        if op.kind == "dropout":
            assert v.shape == (n, 2, 3) and v.dtype == torch.bool
        elif op.kind == "invert":
            assert v.shape == (n, 3) and v.dtype == torch.bool
        elif op.kind in ("add", "multiply", "contrast"):
            assert v.shape == (n, 3)
            assert float(v.min()) >= op.lo and float(v.max()) <= op.hi
            shared = (v[:, 0] == v[:, 1]) & (v[:, 1] == v[:, 2])
            assert abs((1 - shared.float().mean().item())
                       - op.per_channel) < 0.05, op
        elif op.kind == "lighting":
            assert v.shape == (n, 3)
            assert abs(v.std().item() - op.lo) < 0.02
        else:
            assert v.shape == (n,)
    with pytest.raises(ValueError, match="draws"):
        taug.color_augment(torch.zeros(1, 4, 4, 3), params[:1], ops)


@pytest.mark.parametrize("name", ["code", "aae"])
def test_train_preprocessing_with_colour_aug_matches_jax(name):
    """``preprocess_rois_grouped(train=True)`` with ``color_aug_prob`` 0.8
    against the JAX package's, its DZI boxes and aug draws injected (the
    per-ROI key's k_dzi / k_aug / k_on split); the labels are unchanged by
    the aug."""
    opts = TINY + ["data.color_aug_prob=0.8", f'data.color_aug_type="{name}"']
    cfg_t, cfg_j = TConfig().apply_opts(opts), JConfig().apply_opts(opts)
    frames, rois = tsyn.dummy_grouped_inputs(cfg_t, n_frames=2,
                                             rois_per_frame=3, seed=7,
                                             ship_xyz=True)
    key = jax.random.PRNGKey(2)             # 5 of 6 ROIs augmented
    ref = j_grouped(cfg_j, {k: jnp.asarray(v) for k, v in frames.items()},
                    {k: jnp.asarray(v) for k, v in rois.items()}, key,
                    train=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    ops = taug.get_aug_pipeline(name)
    S = cfg_t.data.input_res
    apply, per_roi = [], []
    for k in jax.random.split(key, len(rois["frame_idx"])):
        _, k_aug, k_on = jax.random.split(k, 3)
        apply.append(bool(jax.random.bernoulli(k_on, 0.8)))
        per_roi.append(jax_draws(k_aug, ops, (S, S)))
    assert 0 < sum(apply) < len(apply), "both branches should occur"
    t_frames = {k: torch.from_numpy(v) for k, v in frames.items()}
    t_rois = {k: torch.from_numpy(v) for k, v in rois.items()}
    cs = (torch.tensor(ref["bbox_center"]), torch.tensor(ref["scale"]))
    ours = t_grouped(cfg_t, t_frames, t_rois, train=True, center_scale=cs,
                     aug_params={"apply": torch.tensor(apply),
                                 "ops": batch_draws(per_roi)})
    ours = {k: v.numpy() for k, v in ours.items()}
    np.testing.assert_allclose(ours["roi_img"][..., :3],
                               ref["roi_img"][..., :3], rtol=0, atol=2e-4)
    plain = t_grouped(cfg_t.apply_opts(["data.color_aug_prob=0.0"]),
                      t_frames, t_rois, train=True, center_scale=cs)
    changed = np.abs(plain["roi_img"].numpy()[..., :3]
                     - ours["roi_img"][..., :3]).max(axis=(1, 2, 3)) > 0
    assert not any(c and not a for c, a in zip(changed, apply)), \
        "the aug touched a ROI whose Bernoulli was off"
    assert changed.any()
    for k in ("roi_img", "roi_mask_visib", "roi_region", "roi_xyz"):
        if k == "roi_img":
            np.testing.assert_array_equal(ours[k][..., 3:],
                                          plain[k].numpy()[..., 3:])
        else:
            np.testing.assert_array_equal(ours[k], plain[k].numpy(), k)
    # drawn from a generator instead: runs, finite, deterministic
    g = [torch.Generator().manual_seed(5) for _ in range(2)]
    a, b = (t_grouped(cfg_t, t_frames, t_rois, train=True, generator=gi)
            for gi in g)
    assert torch.isfinite(a["roi_img"]).all()
    assert torch.equal(a["roi_img"], b["roi_img"])
