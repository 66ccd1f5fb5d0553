"""The reference against the port at tiny widths on the CPU, and what the
benchmark imports."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from port_bench.harness import context as hctx
from port_bench.harness.manifest import Manifest
from port_bench.tests.tiny import ROOT, TINY, run_tiny, small_cell

BENCH = os.path.join(ROOT, "port_bench")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(top):
    for d, _, names in os.walk(top):
        yield from (os.path.join(d, n) for n in names if n.endswith(".py"))


def test_reference_imports_nothing_of_the_port():
    for path in _files(os.path.join(BENCH, "reference")):
        bad = set(_imports(path)) & {"rdpn6d_tpu_torch", "rdpn6d_tpu",
                                     "jax", "jaxlib", "flax", "port_bench"}
        assert not bad, (path, bad)


def test_no_file_of_the_benchmark_imports_jax():
    for path in _files(BENCH):
        if os.sep + "tests" + os.sep in path:
            continue
        bad = set(_imports(path)) & {"rdpn6d_tpu", "jax", "jaxlib", "flax"}
        assert not bad, (path, bad)


@pytest.mark.parametrize("cell", ["lm13.serve.b64", "lm13.train.b96",
                                  "ycbv.train.pbr.b96",
                                  "ycbv.serve.int8.b64"])
def test_a_rehearsal_loads_no_jax(cell):
    """Each driver's run in a fresh interpreter: no loaded module's
    top-level name is jax's, jaxlib's, flax's or rdpn6d_tpu's."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from port_bench.tests.tiny import run_tiny\n"
            "from port_bench.harness.main import forbidden_modules\n"
            "rc, res = run_tiny(%r, trace=1)\n"
            "assert rc == 0 and res['correct'] is not None\n"
            "print('FOUND', forbidden_modules())\n") % (ROOT, cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout


@pytest.mark.parametrize("cell", ["lm13.train.b96", "ycbv.train.pbr.b96"])
def test_train_reference_is_the_port_in_float32(cell):
    """Three steps of the port in float32 and of the reference agree bit
    for bit: every loss, the first gradient and the change of every leaf
    (the crop, the labels (gt_labels or surface_labels), the colour
    augmentation, the model, the losses and Ranger)."""
    rc, res = run_tiny(cell, opts=["solver.amp=false"])
    assert rc == 0
    assert all(c["value"] == 0.0 for c in res["checks"].values()), res


def test_serve_reference_is_the_port():
    """The served bf16 model and the reference cast alike give the same
    poses: the crop, the trunk, the fusion, the head, ConvPnP and the
    pose recovery."""
    m = Manifest(ROOT)
    cell = small_cell(m, "lm13.serve.b64")
    ctx = hctx.Context(cell, m.config("lm13"), 5, torch.device("cpu"), TINY)
    drv = m.driver("serve").Driver(ctx)
    for i in range(3):
        drv.collect(i, drv.launch(i))
    gaps = drv.compare(drv.poses, drv.reference_poses([0, 1, 2], None))
    assert gaps["rot_gap_deg"] < 1e-3 and gaps["trans_gap"] < 1e-5, gaps


def test_int8_reference_is_the_ports_int8_head():
    """The port's int8-head-static against the reference's 8-bit
    emulation with its own calibration: the same poses, far nearer than
    the 4-bit control."""
    m = Manifest(ROOT)
    cell = small_cell(m, "ycbv.serve.int8.b64")
    ctx = hctx.Context(cell, m.config("ycbv"), 5, torch.device("cpu"), TINY)
    drv = m.driver("serve").Driver(ctx)
    for i in range(3):
        drv.collect(i, drv.launch(i))
    eight = drv.compare(drv.poses, drv.reference_poses([0, 1, 2], bits=8))
    four = drv.compare(drv.poses, drv.reference_poses([0, 1, 2], bits=4))
    assert eight["rot_gap_deg"] < 1e-3 and eight["trans_gap"] < 1e-5, eight
    assert four["rot_gap_deg"] > 1.0, four
