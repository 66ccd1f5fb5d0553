"""A traced sub-window: the profiler's kernels, attributed to the
benchmark's ranges.

The drivers wrap their calls into each layer in ``torch.profiler``
``record_function`` ranges named ``bench.<layer>``. A kernel belongs to
the innermost range that encloses the host call that launched it (the
runtime event of the same correlation id). The traced window runs from
the first range's start to the last one's end; the device is busy where
a kernel, a copy or a memset runs, and an idle gap is named by the range
the host was in when it began. The Chrome trace goes to ``TMPDIR`` and is
deleted once read.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable

RANGE_PREFIX = "bench."
_DEVICE_BUSY = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)   # (name, seconds, range)
    gaps: list = field(default_factory=list)      # (range, seconds)

    def range_seconds(self, name: str) -> float:
        return sum(s for _, s, r in self.kernels if r == name)

    def kernel_seconds(self, kernel: str) -> tuple[float, int]:
        """Device seconds and launches of the kernel whose identifier is
        ``kernel``, whatever its namespace, template and arguments."""
        word = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(kernel)
                          + r"(?![A-Za-z0-9_])")
        hits = [s for n, s, _ in self.kernels if word.search(n)]
        return sum(hits), len(hits)

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = defaultdict(float)
        for n, s, _ in self.kernels:
            by_name[n[:160]] += s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[r, s] for r, s in gaps]}


def capture(fn: Callable[[], None], activities) -> Trace:
    """Run ``fn`` (which ends in a device synchronize) under the profiler
    and reduce its trace."""
    import torch

    with torch.profiler.profile(activities=activities) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_events(events)


def reduce_events(events: list[dict]) -> Trace:
    ranges, launch_ts, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "user_annotation" and e["name"].startswith(RANGE_PREFIX):
            ranges.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                           e["name"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])
        elif cat in _DEVICE_BUSY:
            device.append(e)
    if not ranges:
        return Trace(0.0, 0.0)
    ranges.sort()
    starts = [r[0] for r in ranges]
    w0, w1 = ranges[0][0], max(r[1] for r in ranges)

    def range_at(ts: float) -> str:
        # the innermost enclosing range: the latest-starting one that
        # has not ended
        j = bisect_right(starts, ts) - 1
        while j >= 0:
            s, e, name = ranges[j]
            if e >= ts:
                return name
            j -= 1
        return "host:outside"

    kernels, spans = [], []
    for e in device:
        t0, dur = float(e["ts"]), float(e["dur"])
        spans.append((t0, t0 + dur))
        if e.get("cat") == "kernel":
            corr = e.get("args", {}).get("correlation")
            where = range_at(launch_ts[corr]) if corr in launch_ts \
                else "host:unknown"
            kernels.append((e["name"], dur * 1e-6, where))
    busy, gaps = 0.0, []
    cursor = w0
    for s, e in sorted(spans):
        s, e = max(s, w0), min(e, w1)
        if e <= cursor:
            continue
        if s > cursor:
            gaps.append((range_at(cursor), (s - cursor) * 1e-6))
            busy += e - s
        else:
            busy += e - cursor
        cursor = e
    if cursor < w1:
        gaps.append((range_at(cursor), (w1 - cursor) * 1e-6))
    return Trace((w1 - w0) * 1e-6, busy * 1e-6, kernels, gaps)
