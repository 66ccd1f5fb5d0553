"""The program's own spans in a traced sub-window.

While a profiler records, the port opens ``record_function`` ranges of
its own, ``rdpn.<name>`` (``rdpn6d_tpu_torch/utils/profiling.span``):
``rdpn.pre`` and its children in preprocessing, ``rdpn.eval`` and
``rdpn.model.*`` in serving, ``rdpn.step`` and ``rdpn.step.*`` in a
train step. ``reduce_spans`` reads them from the same Chrome-trace
events as ``trace.reduce_events``, which takes no notice of them, so the
benchmark's ``bench.*`` attribution is the same with or without them.

- A span's device time counts every kernel whose launching runtime call
  began inside any of its instances, by timestamp and whatever the
  thread: backward kernels are launched from the autograd engine's
  thread while the main thread waits inside ``rdpn.step.backward``. A
  nested span counts toward every span that encloses it.
- A span's host time is its self time: its instances' length less that
  of the spans nested in them on the same thread.
- The synchronising runtime calls (``SYNC_CALLS``) made while any span
  is open are kept with the innermost span open at their start.
- Each idle gap of the device in the traced window (as ``trace.py``
  finds them) is named by the innermost range open at its start, the
  benchmark's or the program's.

A program without spans leaves the first three empty.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import Counter, defaultdict
from dataclasses import dataclass, field

from .trace import _DEVICE_BUSY, RANGE_PREFIX

SPAN_PREFIX = "rdpn."
# the CUDA runtime calls that block the host until the device has caught
# up, as Kineto names them (torch 2.11, CUDA 12.8); a blocking copy shows
# as cudaMemcpyAsync followed by cudaStreamSynchronize
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})


@dataclass
class Spans:
    device: dict = field(default_factory=dict)     # span -> seconds
    host_self: dict = field(default_factory=dict)  # span -> host seconds
    syncs: list = field(default_factory=list)      # (call, innermost span)
    gaps: list = field(default_factory=list)       # (range or span, seconds)

    def sync_count(self) -> int | None:
        """Synchronising calls made inside the spans; None where the
        program opened no span."""
        return len(self.syncs) if self.host_self else None

    def per_item(self, items: int, top: int = 10) -> dict:
        """Each span's device and host self ms an item, the synchronising
        calls an item by call and span, and the longest idle gaps."""
        return {
            "spans": {n: {"device_ms": 1e3 * self.device.get(n, 0.0) / items,
                          "host_self_ms": 1e3 * self.host_self[n] / items}
                      for n in sorted(self.host_self)},
            "syncs_per_item": {f"{c} in {s}": k / items for (c, s), k in
                               sorted(Counter(self.syncs).items())},
            "idle_gaps": [[r, s] for r, s in
                          sorted(self.gaps, key=lambda g: -g[1])[:top]]}


def _innermost(ranges: list[tuple]):
    """Of ``ranges`` (start, end, name, ...) sorted by start, the name of
    the innermost one open at a time: the latest-starting one that has
    not ended."""
    starts = [r[0] for r in ranges]

    def at(ts: float, outside: str) -> str:
        j = bisect_right(starts, ts) - 1
        while j >= 0:
            if ranges[j][1] >= ts:
                return ranges[j][2]
            j -= 1
        return outside

    return at


def reduce_spans(events: list[dict]) -> Spans:
    ranges, spans, launch_ts, busy, sync_ts = [], [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(RANGE_PREFIX):
            ranges.append((t0, t1, name))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((t0, t1, name, (e.get("pid"), e.get("tid"))))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = t0
            if name in SYNC_CALLS:
                sync_ts.append((t0, name))
        elif cat in _DEVICE_BUSY:
            busy.append((t0, t1, cat, e.get("args", {}).get("correlation")))
    spans.sort(key=lambda s: s[:3])
    span_at = _innermost(spans)
    launched = [(launch_ts[corr], (t1 - t0) * 1e-6)
                for t0, t1, cat, corr in busy
                if cat == "kernel" and corr in launch_ts]
    syncs = [(call, span_at(ts, "")) for ts, call in sorted(sync_ts)
             if span_at(ts, "")]
    gaps = []
    if ranges:
        either_at = _innermost(sorted(ranges + [s[:3] for s in spans]))
        gaps = [(either_at(t, "host:outside"), s)
                for t, s in _idle_gaps(ranges, busy)]
    return Spans(_span_device(spans, launched), _span_self(spans), syncs,
                 gaps)


def _idle_gaps(ranges: list[tuple], busy: list[tuple]) -> list[tuple]:
    """(start, seconds) of each stretch of the traced window, from the
    first ``bench.*`` range's start to the last one's end, in which no
    kernel, copy or memset runs: ``trace.reduce_events``'s gaps."""
    w0, w1 = min(r[0] for r in ranges), max(r[1] for r in ranges)
    gaps, cursor = [], w0
    for s, e, *_ in sorted(busy, key=lambda b: b[:2]):
        s, e = max(s, w0), min(e, w1)
        if e <= cursor:
            continue
        if s > cursor:
            gaps.append((cursor, (s - cursor) * 1e-6))
        cursor = e
    if cursor < w1:
        gaps.append((cursor, (w1 - cursor) * 1e-6))
    return gaps


def _span_device(spans: list[tuple], launched: list[tuple]) -> dict:
    """Each span's device seconds: the kernels whose launch lies inside
    any of its instances (their union, so a kernel counts once a span)."""
    instances: dict[str, list] = defaultdict(list)
    for s, e, name, _ in spans:
        merged = instances[name]
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    out = {}
    for name, merged in instances.items():
        starts = [m[0] for m in merged]
        total = 0.0
        for ts, seconds in launched:
            j = bisect_right(starts, ts) - 1
            if j >= 0 and ts <= merged[j][1]:
                total += seconds
        out[name] = total
    return out


def _span_self(spans: list[tuple]) -> dict:
    """Each span's host self time: its instances' length less that of
    the spans directly nested in them on the same thread."""
    out: dict[str, float] = defaultdict(float)
    stacks: dict[tuple, list] = defaultdict(list)
    # parents before their children: by start, the longer first
    for s, e, name, thread in sorted(spans, key=lambda x: (x[0], -x[1])):
        stack = stacks[thread]
        while stack and stack[-1][1] <= s:
            stack.pop()
        out[name] += (e - s) * 1e-6
        if stack:
            out[stack[-1][2]] -= (e - s) * 1e-6
        stack.append((s, e, name))
    return dict(out)
