"""The train data path of the port against the JAX package's, on one
synthetic tree on disk: records (BOP-layout ``lm`` train lists and the
``imgn`` layout), ``load_train_records`` and the iteration count, the
samplers' index streams, the per-ROI compact decode, the frame-grouped
decode pool's batches, the device frame cache, the pretrained trunk and
the metric writers' lines.

The tree is ``data/synthetic.write_lm_tree`` + ``write_lm_imgn_tree`` (two
cube objects, 3 frames each in each layout; PNGs through the port's codec,
which OpenCV reads back bit for bit). Both packages read the same files;
the JAX side decodes with OpenCV. Tolerance: none. Records, index streams,
decodes and batches are equal (arrays byte for byte, with their dtypes and
shapes); the trunk's tensors equal the JAX package's through
``utils/flax_params``.
"""

import json
import os

import numpy as np
import pytest
import torch

import rdpn6d_tpu.data.refs as jrefs
import rdpn6d_tpu_torch.data.refs as trefs
from rdpn6d_tpu.config import Config as JConfig
from rdpn6d_tpu.data import bop as jbop
from rdpn6d_tpu.data import loader as jloader
from rdpn6d_tpu.data import sampler as jsampler
from rdpn6d_tpu.data.assets import load_class_assets as j_assets
from rdpn6d_tpu.engine.writers import JsonWriter as JJsonWriter
from rdpn6d_tpu_torch.config import Config as TConfig
from rdpn6d_tpu_torch.data import bop as tbop
from rdpn6d_tpu_torch.data import loader as tloader
from rdpn6d_tpu_torch.data import sampler as tsampler
from rdpn6d_tpu_torch.data.assets import load_class_assets as t_assets
from rdpn6d_tpu_torch.data.device_cache import DeviceFrameCache
from rdpn6d_tpu_torch.data.synthetic import (
    write_lm_imgn_tree,
    write_lm_tree,
    write_resnet_pth,
)
from rdpn6d_tpu_torch.engine.writers import JsonWriter as TJsonWriter

OBJS = {"ape": 1, "can": 5}
SPLITS = ["tiny_lm_train", "tiny_imgn_train"]
OPTS = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16", "loss.num_pm_points=500",
        "solver.ims_per_batch=4"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tree, and the same train splits registered in both packages:
    the lm train lists, and lm_imgn cut to 2 of 3 frames an object (the
    n_per_obj subsample)."""
    root = str(tmp_path_factory.mktemp("train_tree"))
    write_lm_tree(root, OBJS, frames_per_obj=3, seed=4)
    write_lm_imgn_tree(root, OBJS, frames_per_obj=3, seed=5)
    for mod in (jbop, tbop):
        mod.register_split(mod.Split(
            "tiny_lm_train", "lm", "test", objs=tuple(OBJS),
            per_obj_index="image_set/{obj}_train.txt"))
        mod.register_split(mod.Split(
            "tiny_imgn_train", "lm_imgn", "imgn", objs=tuple(OBJS),
            n_per_obj=2, per_obj_index="image_set/train_{obj}.txt"))
        mod.register_split(mod.Split(
            "tiny_imgn_all", "lm_imgn", "imgn", objs=tuple(OBJS),
            per_obj_index="image_set/train_{obj}.txt"))
    return root


@pytest.fixture
def data_root(tree, monkeypatch):
    monkeypatch.setattr(jrefs, "DATA_ROOT", tree)
    monkeypatch.setattr(trefs, "DATA_ROOT", tree)
    return tree


def assert_same(a, b, where=""):
    """Equal nested records or batches: arrays byte for byte with their
    dtypes and shapes, everything else by ==."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), \
            (where, set(a) ^ set(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (where, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("split,flatten", [
    ("tiny_lm_train", True), ("tiny_imgn_train", True),
    ("tiny_imgn_all", True), ("tiny_imgn_all", False)])
def test_records_match_jax(data_root, split, flatten):
    t = tbop.build_split_records(tbop.get_split(split), flatten=flatten)
    j = jbop.build_split_records(jbop.get_split(split), flatten=flatten)
    assert len(t) == {"tiny_lm_train": 6, "tiny_imgn_train": 4,
                      "tiny_imgn_all": 6}[split]
    assert_same(t, j)
    if split.startswith("tiny_imgn") and flatten:
        assert all(r["bbox_visib"] is None and r["mask_visib_path"] == ""
                   and os.path.exists(r["xyz_path"]) for r in t)
        # n_per_obj picks by linspace over the index: ids 1000 and 1002
        if split == "tiny_imgn_train":
            assert [r["im_id"] for r in t] == [1000, 1002, 1000, 1002]


def test_load_train_records_and_iterations_match_jax(data_root, tmp_path):
    cfgs = [JConfig().apply_opts(OPTS), TConfig().apply_opts(OPTS)]
    j = jloader.load_train_records(cfgs[0], SPLITS,
                                   cache_dir=str(tmp_path / "j"))
    t = tloader.load_train_records(cfgs[1], SPLITS,
                                   cache_dir=str(tmp_path / "t"))
    assert_same(t, j)
    # the records cache serves the same list a second time
    assert_same(tloader.load_train_records(
        cfgs[1], SPLITS, cache_dir=str(tmp_path / "t")), j)
    # epochs -> iterations, as both CLIs compute them
    bs = cfgs[1].solver.ims_per_batch
    assert max(len(t) // bs, 1) * 160 == 2 * 160
    with pytest.raises(RuntimeError, match="no records"):
        tloader.load_train_records(TConfig().apply_opts(
            ["data.filter_visib_thr=2.0"]), SPLITS)


@pytest.mark.parametrize("kind", ["shuffle", "ordered", "sharded",
                                  "repeat_records", "repeat_frames"])
def test_sampler_streams_match_jax(kind):
    def first(sampler, n=300):
        it = iter(sampler)
        return [next(it) for _ in range(n)]

    cats = [0, 0, 0, 1, 2, 2, 0, 3, 0, 0, 1]
    frames = [[0], [0, 1], [2], [0, 0, 3], [1], [0]]
    mods = (tsampler, jsampler)
    if kind == "shuffle":
        a, b = (m.InfiniteSampler(7, seed=3) for m in mods)
    elif kind == "ordered":
        a, b = (m.InfiniteSampler(7, shuffle=False) for m in mods)
    elif kind == "sharded":
        a, b = (m.InfiniteSampler(9, seed=1, shard_id=1, num_shards=3)
                for m in mods)
    elif kind == "repeat_records":
        a, b = (m.RepeatFactorSampler(cats, 0.3, seed=2) for m in mods)
    else:
        reps = [m.frame_repeat_factors(frames, 0.5) for m in mods]
        np.testing.assert_array_equal(reps[0], reps[1])
        assert reps[0].max() > 1
        a, b = (m.RepeatFactorSampler(repeat_factors=r, seed=2)
                for m, r in zip(mods, reps))
    assert first(a) == first(b)


def _decoders(data_root, opts, seed=0):
    tcfg, jcfg = TConfig().apply_opts(opts), JConfig().apply_opts(opts)
    jref, tref = jrefs.get_ref("lm"), trefs.get_ref("lm")
    jdec = jloader.RecordDecoder(
        jcfg, j_assets(jref, 4, 500, objs=list(OBJS)), train=True, seed=seed)
    tdec = tloader.RecordDecoder(
        tcfg, t_assets(tref, 4, 500, objs=list(OBJS)), train=True, seed=seed)
    return tdec, jdec


@pytest.mark.parametrize("ship_crops", [True, False])
@pytest.mark.parametrize("ship_xyz", [True, False])
def test_decode_roi_compact_matches_jax(data_root, ship_crops, ship_xyz):
    """Each record of both layouts: the shared frame and the instance's
    compact GT, byte for byte. The lm records carry a mask file and an xyz
    crop; the imgn ones only the crop (the mask comes from it). Without
    ship_xyz, no xyz is shipped and the mask stays the file's (lm) or
    depth > 0 (imgn)."""
    opts = OPTS + [f"data.ship_crops={str(ship_crops).lower()}"]
    tdec, jdec = _decoders(data_root, opts)
    recs = tloader.load_train_records(TConfig().apply_opts(opts), SPLITS)
    for visit, rec in enumerate(recs):
        frame = tdec.read_frame(rec)
        assert_same(frame, jdec.read_frame(rec), "frame")
        t_roi, t_private = tdec.decode_roi_compact(rec, frame, visit=visit,
                                                   ship_xyz=ship_xyz)
        j_roi, j_private = jdec.decode_roi_compact(rec, frame, visit=visit,
                                                   ship_xyz=ship_xyz)
        assert t_private is None and j_private is None
        assert_same(t_roi, j_roi, rec["rgb_path"])
        assert ("xyz" in t_roi) == ship_xyz
        assert ("xyz_offset" in t_roi) == (ship_xyz and ship_crops)
        assert t_roi["mask_packed"].any()


def test_depth_fallback_xyz_matches_jax(data_root):
    """A record whose xyz crop is missing ships the depth surface's coords
    (cropped to their own box with ship_crops)."""
    tdec, jdec = _decoders(data_root, OPTS)
    rec = dict(tloader.load_train_records(TConfig().apply_opts(OPTS),
                                          SPLITS)[0])
    rec["xyz_path"] = rec["xyz_path"] + ".absent"
    frame = tdec.read_frame(rec)
    t_roi, _ = tdec.decode_roi_compact(rec, frame)
    j_roi, _ = jdec.decode_roi_compact(rec, frame)
    assert_same(t_roi, j_roi)
    assert np.abs(t_roi["xyz"].astype(np.float32)).sum() > 0
    assert tdec._record_rng(rec, 3).randint(1 << 30) == \
        jdec._record_rng(rec, 3).randint(1 << 30)


@pytest.mark.parametrize("workers", [1, 3])
def test_train_group_iterator_matches_jax(data_root, workers):
    """The first 3 batches of the decode pool, byte for byte, at 1 and 3
    decode threads: frames stacked (padded to the frame bucket) or, with
    yield_keys, as (key, frame) slots."""
    tcfg, jcfg = TConfig().apply_opts(OPTS), JConfig().apply_opts(OPTS)
    for keys in (False, True):
        t_it = tloader.train_group_iterator(
            tcfg, SPLITS, seed=3, num_workers=workers, frame_bucket=3,
            yield_keys=keys)
        j_it = jloader.train_group_iterator(
            jcfg, SPLITS, seed=3, num_workers=workers, frame_bucket=3,
            yield_keys=keys)
        for i in range(3):
            tb, jb = next(t_it), next(j_it)
            assert_same(tb, jb, f"batch {i}")
            assert tb["rois"]["frame_idx"].shape == (4,)
            n_frames = len(tb["frame_slots"]) if keys \
                else tb["frames"]["rgb"].shape[0]
            assert n_frames in (3, 4)        # bucket of 3, capped at bs
            assert "xyz_offset" in tb["rois"]
        t_it.close()


def test_frames_of_two_datasets_with_one_image_id_stay_apart(tmp_path,
                                                            monkeypatch):
    """An lm_imgn render whose id equals an LM image's (scene_id = obj_id
    on both) is a frame of its own: grouped by image file, not by (scene,
    im id) as the JAX package groups them, its ROI reads its own pixels."""
    root = str(tmp_path)
    write_lm_tree(root, {"ape": 1}, frames_per_obj=2, seed=1)
    write_lm_imgn_tree(root, {"ape": 1}, frames_per_obj=2, seed=2,
                       first_id=0)
    monkeypatch.setattr(trefs, "DATA_ROOT", root)
    tbop.register_split(tbop.Split(
        "clash_lm", "lm", "test", objs=("ape",),
        per_obj_index="image_set/{obj}_train.txt"))
    tbop.register_split(tbop.Split(
        "clash_imgn", "lm_imgn", "imgn", objs=("ape",),
        per_obj_index="image_set/train_{obj}.txt"))
    cfg = TConfig().apply_opts(OPTS)
    recs = tloader.load_train_records(cfg, ["clash_lm", "clash_imgn"])
    assert len({(r["scene_id"], r["im_id"]) for r in recs}) == 2
    it = tloader.train_group_iterator(cfg, ["clash_lm", "clash_imgn"],
                                      num_workers=1, yield_keys=True)
    batch = next(it)
    it.close()
    keys = [k for k, _ in batch["frame_slots"]]
    assert len(set(keys)) == 4, "one frame a ROI"
    for i, fidx in enumerate(batch["rois"]["frame_idx"]):
        rec = next(r for r in recs if r["rgb_path"] == keys[fidx])
        np.testing.assert_array_equal(batch["rois"]["gt_rot"][i], rec["R"])


def test_train_group_iterator_surfaces_producer_errors(data_root):
    class Broken(tloader.RecordDecoder):
        def read_frame(self, rec):
            raise ValueError("corrupt frame")

    cfg = TConfig().apply_opts(OPTS)
    it = tloader.train_group_iterator(
        cfg, SPLITS, decoder=Broken(cfg, train=True), num_workers=2)
    with pytest.raises(RuntimeError, match="producer") as err:
        next(it)
    assert isinstance(err.value.__cause__, ValueError)


def test_train_refusals(data_root):
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        tloader.RecordDecoder(TConfig().apply_opts(
            ["data.change_bg_prob=0.5"]), train=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        tloader.train_frame_iterator(TConfig(), SPLITS)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        tbop.build_split_records(tbop.get_split("mp6d_train"))


def _frame(rng, h=6, w=8):
    return {"rgb": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
            "depth_raw": rng.randint(0, 65536, (h, w)).astype(np.uint16),
            "depth_factor": np.float32(1000.0),
            "K": rng.rand(3, 3).astype(np.float32)}


def test_device_frame_cache_on_cpu():
    """The stacked frames equal np.stack of the slots (raw depth as its
    uint16 values in int32); resident frames are not uploaded again;
    eviction by bytes, least recent first; private frames always stream;
    the stats carry the JAX package's keys."""
    from rdpn6d_tpu.data.device_cache import DeviceFrameCache as JCache

    rng = np.random.RandomState(0)
    fr = [_frame(rng) for _ in range(4)]
    per = sum(v.nbytes for k, v in fr[0].items() if k != "depth_raw") \
        + fr[0]["depth_raw"].nbytes
    cache = DeviceFrameCache(2 * per + per // 2, "cpu")
    slots = [("a", fr[0]), ("b", fr[1]), ("b", fr[1]), (None, fr[2])]
    out = cache.stack(slots)
    for k in fr[0]:
        want = np.stack([f[k] for _, f in slots])
        assert out[k].dtype == (torch.int32 if k == "depth_raw"
                                else torch.from_numpy(want).dtype)
        np.testing.assert_array_equal(out[k].numpy(), want)
    assert (cache.hits, cache.misses, len(cache)) == (1, 3, 2)
    assert cache.resident_bytes == 2 * per
    cache.stack([("a", fr[0])])                 # a is now the newest
    cache.stack([("c", fr[3])])                 # evicts b, the oldest
    assert len(cache) == 2 and (cache.hits, cache.misses) == (2, 4)
    cache.stack([("b", fr[1])])
    assert cache.misses == 5, "b was evicted"
    stats = cache.stats()
    assert set(stats) == set(JCache(1 << 20).stats())
    assert stats["frame_cache_hit_rate"] == 2 / 7
    with pytest.raises(ValueError):
        DeviceFrameCache(0, "cpu")


def test_json_writer_lines_match_jax(tmp_path):
    metrics = {"total_loss": 1.5, "loss_mask": np.float32(0.25),
               "grad_norm": 3.0, "frame_cache_hit_rate": 0.5}
    lines = []
    for cls, name in ((JJsonWriter, "j"), (TJsonWriter, "t")):
        w = cls(str(tmp_path / name / "metrics.json"))
        for step in (1, 2):
            w.write(step, {**metrics, "lr": 1e-4 * step})
        w.close()
        lines.append([json.loads(ln) for ln in
                      open(tmp_path / name / "metrics.json")])
    assert lines[0] == lines[1]
    assert set(lines[1][0]) == {"iteration", "lr", *metrics}


def test_load_pretrained_backbone_matches_jax(tmp_path, monkeypatch):
    """The same seeded torchvision-keyed .pth through both packages: the
    JAX trunk, carried to torch names by utils/flax_params, equals the
    port's trunk tensor for tensor (BatchNorm counters aside)."""
    import jax
    import jax.numpy as jnp

    from rdpn6d_tpu.models import RDPN as JRDPN
    from rdpn6d_tpu.models import dummy_batch
    from rdpn6d_tpu.utils.torch_convert import \
        load_pretrained_backbone as j_load
    from rdpn6d_tpu_torch.models import RDPN, init_weights
    from rdpn6d_tpu_torch.utils.flax_params import carry, resnet_state
    from rdpn6d_tpu_torch.utils.pretrained import load_pretrained_backbone

    pth = write_resnet_pth(str(tmp_path / "pre" / "resnet18-seeded.pth"),
                           depth=18, seed=7)
    monkeypatch.setenv("RDPN6D_PRETRAINED_DIR", str(tmp_path / "pre"))
    cfg = JConfig().apply_opts(OPTS)
    variables = JRDPN(cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), dummy_batch(cfg, 1), train=False)
    jv = j_load(variables, "torchvision://resnet18", depth=18)
    want = carry(lambda w: resnet_state(w, 18, "backbone", ("backbone",)),
                 jax.device_get(jv["params"]),
                 jax.device_get(jv["batch_stats"]))
    model = init_weights(RDPN(TConfig().apply_opts(OPTS)),
                         torch.Generator().manual_seed(0))
    load_pretrained_backbone(model, "torchvision://resnet18", depth=18)
    got = model.state_dict()
    sd = torch.load(pth, weights_only=True)
    n = 0
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(got[k], v), k
        assert torch.equal(got[k], sd[k[len("backbone."):]]), k
        n += 1
    assert n == sum(1 for k in sd if not k.startswith("fc.")
                    and not k.endswith("num_batches_tracked"))


def test_resolve_pretrained_search_and_refusals(tmp_path, monkeypatch):
    """The search order of a torchvision:// spec (only file names count
    here, so the files are empty), and a file that is not the trunk."""
    from rdpn6d_tpu_torch.models import RDPN
    from rdpn6d_tpu_torch.utils.pretrained import (
        load_pretrained_backbone,
        resolve_pretrained,
    )

    def touch(*parts):
        path = tmp_path.joinpath(*parts)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"")
        return str(path)

    for var, sub in (("RDPN6D_PRETRAINED_DIR", "a"), ("TORCH_HOME", "b"),
                     ("RDPN6D_DATA_ROOT", "c")):
        monkeypatch.setenv(var, str(tmp_path / sub))
    with pytest.raises(FileNotFoundError, match="from scratch"):
        resolve_pretrained("torchvision://resnet18", 18)
    late = touch("c", "pretrained", "resnet18-late.pth")
    touch("c", "pretrained", "resnet34-other.pth")
    assert resolve_pretrained("torchvision://resnet18", 18) == late
    early = touch("b", "hub", "checkpoints", "resnet18-early.pth")
    assert resolve_pretrained("torchvision://resnet18", 18) == early
    first = touch("a", "resnet18-first.pth")
    assert resolve_pretrained("torchvision://resnet18", 18) == first
    assert resolve_pretrained(late) == late and resolve_pretrained("") == ""
    with pytest.raises(ValueError, match="scheme"):
        resolve_pretrained("http://resnet18")
    with pytest.raises(FileNotFoundError):
        resolve_pretrained(str(tmp_path / "none.pth"))
    partial = str(tmp_path / "stem_only.pth")
    torch.save({"conv1.weight": torch.zeros(64, 3, 7, 7)}, partial)
    with pytest.raises(ValueError, match="not a ResNet-18 trunk"):
        load_pretrained_backbone(RDPN(TConfig().apply_opts(OPTS)), partial,
                                 depth=18)
