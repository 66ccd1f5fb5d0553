"""The program's spans in a traced sub-window (``harness/spans.py``) on a
small recorded trace, the benchmark's readers unchanged by them, and
``span_split.py``'s traced runs at tiny widths on the CPU."""

import pytest
import torch

from port_bench.harness.manifest import Manifest
from port_bench.harness.readers import Run
from port_bench.harness.spans import reduce_spans
from port_bench.harness.trace import reduce_events
from port_bench.span_split import keeping_events, split
from port_bench.tests.test_port_bench_trace import EVENTS, _x
from port_bench.tests.tiny import ROOT, SMALL, run_tiny

# a third item, a train step, whose backward kernel is launched from the
# autograd engine's thread (tid 2) while the main thread (tid 1) waits
# inside rdpn.step.backward
STEP_ITEM = [
    _x("user_annotation", "bench.step", 60, 40),
    _x("cuda_runtime", "cudaLaunchKernel", 63, 1, correlation=4),
    dict(_x("cuda_runtime", "cudaLaunchKernel", 75, 1, correlation=5),
         tid=2),
    _x("cuda_runtime", "cudaLaunchKernel", 86, 1, correlation=6),
    _x("kernel", "fwd_conv", 64, 4, correlation=4),
    _x("kernel", "bwd_conv", 76, 8, correlation=5),
    _x("kernel", "ranger", 87, 3, correlation=6),
]
SPANS = [
    _x("user_annotation", "rdpn.pre", 1, 8.5),
    _x("user_annotation", "rdpn.pre.crop", 1.5, 2.5),
    _x("user_annotation", "rdpn.eval", 10.5, 19),
    _x("user_annotation", "rdpn.model.trunk", 11, 2),
    _x("user_annotation", "rdpn.model.head", 14, 2),
    _x("user_annotation", "rdpn.step", 61, 38),
    _x("user_annotation", "rdpn.step.forward", 62, 8),
    _x("user_annotation", "rdpn.model.trunk", 62.5, 3.5),
    _x("user_annotation", "rdpn.step.backward", 70, 15),
    _x("user_annotation", "rdpn.step.optimizer", 85, 10),
]
# two synchronising calls inside spans, one outside every span
SYNCS = [
    _x("cuda_runtime", "cudaStreamSynchronize", 3, 0.5),
    _x("cuda_runtime", "cudaStreamSynchronize", 91, 3),
    _x("cuda_runtime", "cudaStreamSynchronize", 45, 1),
]
BASE = [dict(e, tid=e.get("tid", 1)) for e in EVENTS + STEP_ITEM]
SPANNED = BASE + [dict(e, tid=1) for e in SPANS + SYNCS]


def test_span_device_time_is_inclusive_and_by_timestamp():
    s = reduce_spans(SPANNED)
    want = {"rdpn.pre": 4, "rdpn.pre.crop": 4, "rdpn.eval": 16,
            # the eval's gemm and the step forward's conv
            "rdpn.model.trunk": 14, "rdpn.model.head": 6,
            "rdpn.step": 15, "rdpn.step.forward": 4,
            # launched from the second thread
            "rdpn.step.backward": 8, "rdpn.step.optimizer": 3}
    assert s.device == {n: pytest.approx(us * 1e-6)
                        for n, us in want.items()}
    children = sum(s.device["rdpn.step." + c] for c in
                   ("forward", "backward", "optimizer"))
    assert children == pytest.approx(s.device["rdpn.step"])


def test_span_host_self_time():
    s = reduce_spans(SPANNED)
    want = {"rdpn.pre": 6, "rdpn.pre.crop": 2.5, "rdpn.eval": 15,
            "rdpn.model.trunk": 5.5, "rdpn.model.head": 2, "rdpn.step": 5,
            "rdpn.step.forward": 4.5, "rdpn.step.backward": 15,
            "rdpn.step.optimizer": 10}
    assert s.host_self == {n: pytest.approx(us * 1e-6)
                           for n, us in want.items()}


def test_sync_calls_inside_spans():
    s = reduce_spans(SPANNED)
    assert s.syncs == [("cudaStreamSynchronize", "rdpn.pre.crop"),
                       ("cudaStreamSynchronize", "rdpn.step.optimizer")]
    assert s.sync_count() == 2
    # a program without spans: nothing to count, not a count of 0
    assert reduce_spans(BASE + SYNCS).sync_count() is None
    assert reduce_spans(BASE + SPANS).sync_count() == 0
    got = s.per_item(2)
    assert got["syncs_per_item"] == {
        "cudaStreamSynchronize in rdpn.pre.crop": 0.5,
        "cudaStreamSynchronize in rdpn.step.optimizer": 0.5}
    assert got["spans"]["rdpn.step.backward"] == {
        "device_ms": pytest.approx(4e-3), "host_self_ms": pytest.approx(
            7.5e-3)}


def test_idle_gaps_named_by_the_innermost_range_or_span():
    base, spans = reduce_events(BASE), reduce_spans(SPANNED)
    assert [s for _, s in spans.gaps] == [s for _, s in base.gaps]
    assert [r for r, _ in base.gaps] == [
        "bench.preprocess", "bench.preprocess", "bench.readback",
        "bench.readback", "bench.step", "bench.step", "bench.step"]
    assert [r for r, _ in spans.gaps] == [
        "bench.preprocess", "rdpn.pre", "bench.readback", "bench.readback",
        "rdpn.step.forward", "rdpn.step.backward", "rdpn.step.optimizer"]
    assert reduce_spans(BASE).gaps == base.gaps


def _run(events):
    m = Manifest(ROOT)
    shapes = {"roi_crop": [{"S": 64, "O": 16, "H": 48, "W": 64, "F": 1,
                            "rgb_bytes": 1, "depth_bytes": 4,
                            "center": torch.tensor([[32.0, 24.0]]),
                            "scale": torch.tensor([40.0]),
                            "frame_idx": torch.tensor([0])}]}
    return m, Run(reduce_events(events), 2, 10.0, 1e12,
                  [0.002, 0.004, 0.003], shapes, m)


def test_the_benchmarks_readers_unchanged_by_the_programs_spans():
    m, base = _run(BASE)
    _, spanned = _run(SPANNED)
    names = [x["name"] for x in m.data["per_layer"]]
    got = {n: m.reader(n).read(base) for n in names}
    assert got == {n: m.reader(n).read(spanned) for n in names}
    assert sum(v is not None for v in got.values()) >= 10
    assert base.trace.kernels == spanned.trace.kernels
    assert base.trace.gaps == spanned.trace.gaps
    assert (base.trace.window_s, base.trace.busy_s) == \
        (spanned.trace.window_s, spanned.trace.busy_s)


@pytest.mark.parametrize("cell, want", [
    ("lm13.serve.b64", {"rdpn.pre", "rdpn.pre.crop", "rdpn.eval",
                        "rdpn.model.trunk", "rdpn.model.head",
                        "rdpn.model.pnp"}),
    ("ycbv.train.pbr.b96", {"rdpn.pre", "rdpn.pre.crop",
                            "rdpn.pre.color_aug", "rdpn.pre.labels",
                            "rdpn.step", "rdpn.step.forward",
                            "rdpn.step.loss", "rdpn.step.backward",
                            "rdpn.step.optimizer", "rdpn.model.trunk",
                            "rdpn.model.head", "rdpn.model.pnp"}),
])
def test_span_split_of_a_tiny_traced_run(cell, want):
    with keeping_events() as kept:
        rc, line = run_tiny(cell, trace=1)
    assert rc == 0 and line["correct"], line
    (trace, events), = kept
    got = split(trace, events, SMALL["trace_items"])
    assert set(got["spans"]) == want
    assert all(v["host_self_ms"] > 0 for v in got["spans"].values())
    # no card: no kernel, no synchronising call
    assert got["syncs_per_item"] == {} and got["ranges_device_ms"] == {}
    # the harness's own reading of the same window is whole
    assert line["metrics"] and line["device"]["window_s"] > 0
