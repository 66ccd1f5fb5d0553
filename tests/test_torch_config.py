"""Port config vs the JAX package's, field by field."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

from rdpn6d_tpu import config as jcfg
from rdpn6d_tpu_torch import config as tcfg
from rdpn6d_tpu_torch.configs import lm13 as t_lm13

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_lm13():
    spec = importlib.util.spec_from_file_location(
        "jax_lm13", os.path.join(ROOT, "configs", "lm13.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.get_config()


def _fields(cls):
    return [(f.name, f.type) for f in dataclasses.fields(cls)]


SECTIONS = ["BackboneConfig", "HeadConfig", "PnPConfig", "LossConfig",
            "DataConfig", "SolverConfig", "TrainRuntimeConfig",
            "TestConfig", "Config"]


@pytest.mark.parametrize("name", SECTIONS)
def test_schema_matches(name):
    # same field names, declared types and defaults, in the same order
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert _fields(j) == _fields(t)
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())


def test_derived_properties_match():
    for opts in ([], ['head.xyz_loss="CE_coor"', 'head.mask_loss="CE"',
                      'pnp.rot_type="ego_quat"'],
                 ['pnp.rot_type="allo_lie_vec"']):
        j = jcfg.Config().apply_opts(opts)
        t = tcfg.Config().apply_opts(opts)
        for sec, props in (("head", ("coord_dim", "mask_dim",
                                     "region_dim")),
                           ("pnp", ("rot_dim", "is_allo"))):
            for p in props:
                assert getattr(getattr(j, sec), p) == \
                    getattr(getattr(t, sec), p), (opts, sec, p)


OPTS = [
    ["solver.base_lr=3e-4", "head.num_regions=16"],
    ["solver.amp=False", "backbone.rot_concat=True"],   # bare-word bools
    ['test.int8="True"'],                               # quoted: a string
    ['data.test_datasets=["a", "b"]'],                  # list -> tuple
    ["exp_name=foo bar", "pnp.z_type=ABS"],             # non-JSON strings
]


@pytest.mark.parametrize("opts", OPTS)
def test_apply_opts_matches(opts):
    j = jcfg.Config().apply_opts(opts)
    t = tcfg.Config().apply_opts(opts)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for sec in ("solver", "backbone", "test", "data"):
        for f in dataclasses.fields(getattr(t, sec)):
            assert type(getattr(getattr(j, sec), f.name)) is \
                type(getattr(getattr(t, sec), f.name))


@pytest.mark.parametrize("bad", ["solver.amp", "a.b.c=1"])
def test_apply_opts_refuses_like_jax(bad):
    with pytest.raises(ValueError):
        jcfg.Config().apply_opts([bad])
    with pytest.raises(ValueError):
        tcfg.Config().apply_opts([bad])


def test_lm13_matches():
    assert dataclasses.asdict(_jax_lm13()) == \
        dataclasses.asdict(t_lm13.get_config())
    assert t_lm13.get_config().backbone.rot_concat is True


def test_dump_loads_across_packages(tmp_path):
    j = _jax_lm13().apply_opts(["head.num_regions=8"])
    path = str(tmp_path / "cfg.json")
    j.dump(path)
    t = tcfg.load_config(path)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t == tcfg.load_config(path)   # hashable, tuples restored
    t.dump(str(tmp_path / "t.json"))
    with open(path) as a, open(tmp_path / "t.json") as b:
        assert a.read() == b.read()


def test_load_config_python_module():
    path = os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "lm13.py")
    cfg = tcfg.load_config(path, ["head.num_regions=8"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        _jax_lm13().apply_opts(["head.num_regions=8"]))


def test_lmo_matches():
    """The port's lmo config equals the JAX package's field for field."""
    from rdpn6d_tpu_torch.configs import lmo as t_lmo

    spec = importlib.util.spec_from_file_location(
        "jax_lmo", os.path.join(ROOT, "configs", "lmo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert dataclasses.asdict(mod.get_config()) == \
        dataclasses.asdict(t_lmo.get_config())
    d = t_lmo.get_config().data
    assert (d.color_aug_prob, d.color_aug_type, d.change_bg_prob,
            d.truncate_fg) == (0.8, "code", 0.5, True)


COPIES = ["base", "lm13", "lmo", "ycbv", "tless", "tudl", "hb", "icbin",
          "itodd", "mp6d", "mini"]


def _jax_config(name, variant=None):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "configs", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.get_config() if variant is None else mod.get_config(variant)


@pytest.mark.parametrize("name", COPIES)
def test_config_copy_matches(name):
    """Each config copy of the port equals the JAX package's field for
    field, through the port's loader as ``main`` reads it."""
    path = os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", f"{name}.py")
    assert dataclasses.asdict(tcfg.load_config(path)) == \
        dataclasses.asdict(_jax_config(name))


SO_VARIANTS = ["lm/ape", "lmo/ape", "ycbv/002_master_chef_can",
               "mp6d/obj_03", "tless/obj_07", "tudl/can", "itodd/obj_05",
               "icbin/juice_carton", "hb/obj_02"]


@pytest.mark.parametrize("variant", SO_VARIANTS)
def test_so_variant_matches(variant):
    """Every SO family resolves through the port's split registry and
    refs, and equals the JAX package's config for the same variant."""
    path = os.path.join(ROOT, "rdpn6d_tpu_torch", "configs", "so.py")
    t = tcfg.load_config(f"{path}:{variant}")
    assert dataclasses.asdict(t) == \
        dataclasses.asdict(_jax_config("so", variant))
    assert t.head.num_classes == 1 and t.exp_name == \
        "{}SO_{}".format(*variant.split("/"))


@pytest.mark.parametrize("variant", ["tudl", "nope/can", "tudl/nope"])
def test_so_refuses_unknown_variant_like_jax(variant):
    from rdpn6d_tpu_torch.configs import so

    with pytest.raises(ValueError) as t:
        so.get_config(variant)
    with pytest.raises(ValueError) as j:
        _jax_config("so", variant)
    assert str(t.value) == str(j.value)


def test_itodd_and_mp6d_load_then_refuse(tmp_path, monkeypatch):
    """itodd and mp6d load, and what they need, once refused, now reads:
    itodd's gray TIF frames through the image reader (as OpenCV reads
    them in colour), mp6d's ``ycb_style`` records through the record
    builder (the JAX package's records, field for field)."""
    import cv2

    import rdpn6d_tpu.data.refs as jrefs
    import rdpn6d_tpu_torch.data.refs as trefs
    from rdpn6d_tpu.data import bop as jbop
    from rdpn6d_tpu_torch.data import bop, image
    from rdpn6d_tpu_torch.data.synthetic import write_mp6d_tree
    from rdpn6d_tpu_torch.configs import itodd, mp6d
    from tests.test_torch_train_data import assert_same

    cfg = itodd.get_config()
    assert (cfg.head.num_classes, cfg.data.train_datasets) == \
        (28, ("itodd_pbr_train",))
    tif = str(tmp_path / "000000.tif")
    gray = (np.arange(24 * 32) % 251).astype(np.uint8).reshape(24, 32)
    assert cv2.imwrite(tif, gray)
    np.testing.assert_array_equal(
        image.imread_rgb(tif),
        cv2.cvtColor(cv2.imread(tif, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))
    cfg = mp6d.get_config()
    assert cfg.test.error_types == "AUCadd,AUCadi,AUCad,vsd"
    write_mp6d_tree(str(tmp_path), train_frames=1, test_frames=1,
                    insts_per_frame=2, seed=1)
    monkeypatch.setattr(trefs, "DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(jrefs, "DATA_ROOT", str(tmp_path))
    split = cfg.data.train_datasets[0]
    records = bop.build_split_records(bop.get_split(split))
    assert len(records) == 2
    assert_same(records, jbop.build_split_records(jbop.get_split(split)))