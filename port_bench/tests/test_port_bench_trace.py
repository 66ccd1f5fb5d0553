"""The trace reduction and the metric readers on a small recorded trace,
and the roofline formulas against PERF.md's kernel table."""

import math

import pytest
import torch

from port_bench.harness.manifest import Manifest
from port_bench.harness.readers import Run
from port_bench.harness.trace import reduce_events
from port_bench.tests.tiny import ROOT


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


# two items: host ranges, their launches (correlation ids) and kernels
EVENTS = [
    _x("user_annotation", "bench.preprocess", 0, 10),
    _x("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
    _x("user_annotation", "bench.model", 10, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 15, 1, correlation=3),
    _x("user_annotation", "bench.readback", 30, 30),
    _x("kernel", "void roi_crop_kernel<unsigned char>(...)", 5, 4,
       correlation=1),
    _x("kernel", "sm90_xmma_gemm", 14, 10, correlation=2),
    _x("kernel", "elementwise", 24, 6, correlation=3),
    _x("gpu_memcpy", "Memcpy DtoH", 40, 2),
    {"ph": "i", "name": "marker", "ts": 1},
]


def test_reduce_attributes_kernels_to_ranges():
    t = reduce_events(EVENTS)
    assert t.window_s == pytest.approx(60e-6)
    # busy: [5,9] + [14,30] + [40,42]
    assert t.busy_s == pytest.approx(22e-6)
    assert t.range_seconds("bench.preprocess") == pytest.approx(4e-6)
    assert t.range_seconds("bench.model") == pytest.approx(16e-6)
    assert t.kernel_seconds("roi_crop_kernel") == (pytest.approx(4e-6), 1)
    gaps = dict((r, s) for r, s in t.gaps if s > 17e-6)
    assert gaps == {"bench.readback": pytest.approx(18e-6)}
    b = t.breakdown()
    assert b["device_ops"][0] == ["sm90_xmma_gemm", pytest.approx(10e-6)]
    assert len(b["idle_gaps"]) == len(t.gaps) <= 10


def test_readers_on_the_recorded_trace():
    m = Manifest(ROOT)
    t = reduce_events(EVENTS)
    shapes = {"roi_crop": [{"S": 64, "O": 16, "H": 48, "W": 64, "F": 1,
                            "rgb_bytes": 1, "depth_bytes": 4,
                            "center": torch.tensor([[32.0, 24.0]]),
                            "scale": torch.tensor([40.0]),
                            "frame_idx": torch.tensor([0])}]}
    run = Run(t, 2, 10.0, 1e12, [0.002, 0.004, 0.003], shapes, m)
    got = {name: m.reader(name).read(run) for name in (
        "preprocess_device_ms.serve", "model_device_ms.serve",
        "step_mfu.serve", "host_dispatch_ms.serve",
        "launches_per_batch.serve", "device_idle_pct.serve",
        "roi_crop_roofline.serve", "int8_conv_roofline")}
    assert got["preprocess_device_ms.serve"] == pytest.approx(2e-3)
    assert got["model_device_ms.serve"] == pytest.approx(8e-3)
    assert got["step_mfu.serve"] == pytest.approx(100 * 1e13 / 989e12)
    assert got["host_dispatch_ms.serve"] == pytest.approx(3.0)
    assert got["launches_per_batch.serve"] == 1.5
    assert got["device_idle_pct.serve"] == pytest.approx(100 * 38 / 60)
    bound = m.roofline("roi_crop").bound_s(shapes["roi_crop"][0])
    assert got["roi_crop_roofline.serve"] == pytest.approx(
        100 * bound / 4e-6)
    assert got["int8_conv_roofline"] is None   # no launch: left out


@pytest.mark.parametrize("kernel, shape, table_ms", [
    ("gt_labels", {"B": 24, "O": 64, "K": 32}, 0.00103),
    ("surface_labels", {"B": 24, "O": 64, "K": 32}, 0.00085),
    ("int8_conv", {"B": 16, "H": 64, "W": 64, "C": 320, "N": 256, "k": 3,
                   "stride": 1, "pad": 1}, 0.0488),
    ("int8_conv", {"B": 16, "H": 64, "W": 64, "C": 256, "N": 256, "k": 3,
                   "stride": 1, "pad": 1}, 0.0391),
])
def test_roofline_matches_the_kernel_table(kernel, shape, table_ms):
    f = Manifest(ROOT).roofline(kernel)
    assert 1e3 * f.bound_s(shape) == pytest.approx(table_ms, abs=6e-6,
                                                   rel=5e-3)


def test_roi_crop_roofline_brackets_the_served_bound():
    """PERF.md's served shape (16 ROIs of one 480x640 frame, uint8 RGB,
    float32 depth) is bounded at 0.00845 ms: between the outputs with no
    input and the outputs with the whole frame read."""
    f = Manifest(ROOT).roofline("roi_crop")
    base = {"S": 256, "O": 64, "H": 480, "W": 640, "F": 1, "rgb_bytes": 1,
            "depth_bytes": 4, "frame_idx": torch.zeros(16, dtype=torch.long)}
    # 256-pixel windows at unit step tiling the frame: every pixel tapped
    tiles = [[x, y] for x in (128.0, 384.0, 512.0) for y in (128.0, 352.0)]
    whole = f.bound_s(dict(base, center=torch.tensor(
        (tiles * 3)[:16]), scale=torch.full((16,), 256.0)))
    none = f.bound_s(dict(base, center=torch.full((16, 2), -1e4),
                          scale=torch.full((16,), 1.0)))
    assert 1e3 * none < 0.00845 < 1e3 * whole
    assert math.isclose(1e3 * whole, 0.0085468, rel_tol=1e-4)
