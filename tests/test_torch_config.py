"""Port config vs the JAX package's, field by field."""

import dataclasses
import importlib.util
import os

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
