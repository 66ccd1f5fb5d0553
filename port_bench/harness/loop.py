"""The measured window: a closed loop of one host thread.

Item i+1 is launched before item i's answers are read back to the host
(the eval runner's pipelining of batches, the trainer's lag-1 read of its
loss). An item's latency runs from its first call to its answers on the
host; the window runs from the first launch to the last read back, and
launches stop once ``seconds`` have passed.

A driver module may bring a loop of its own as ``window(driver, start,
seconds=None, count=None)``, returning a ``Window``; ``run`` takes it
where there is one, and this closed loop otherwise.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class Window:
    start: int                      # first item index
    items: int = 0                  # items launched and read back
    answers: int = 0                # answers read back (poses or ROIs)
    failed: int = 0                 # items whose answers were not sound
    seconds: float = 0.0            # first launch to last read back
    t_begin: float = 0.0
    latency_s: list = field(default_factory=list)
    dispatch_s: list = field(default_factory=list)   # host time to launch
    done_s: list = field(default_factory=list)       # read back, from t0


def closed_loop(launch: Callable[[int], Any],
                collect: Callable[[int, Any], tuple[int, bool]],
                start: int, seconds: float | None = None,
                count: int | None = None) -> Window:
    """Run items start, start+1, ... until ``seconds`` have passed since
    the first launch (or ``count`` items); ``launch(i)`` enqueues item i
    and returns its handle, ``collect(i, handle)`` reads it back and
    returns (answers, sound)."""
    w = Window(start)
    pending = None
    i = start
    t_begin = w.t_begin = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if count is not None and i - start >= count:
            break
        if seconds is not None and t0 - t_begin >= seconds:
            break
        handle = launch(i)
        w.dispatch_s.append(time.perf_counter() - t0)
        if pending is not None:
            _finish(w, collect, pending)
        pending = (i, handle, t0)
        i += 1
    if pending is not None:
        _finish(w, collect, pending)
    w.seconds = time.perf_counter() - t_begin
    return w


def _finish(w: Window, collect, pending) -> None:
    i, handle, t0 = pending
    n, ok = collect(i, handle)
    t = time.perf_counter()
    w.latency_s.append(t - t0)
    w.done_s.append(t - w.t_begin)
    w.items += 1
    w.answers += n
    w.failed += 0 if ok else 1


def fifths(w: Window) -> list[float]:
    """Items read back a second in each fifth of the window: whether the
    rate holds through a run."""
    edges = [w.seconds * k / 5 for k in range(6)]
    return [sum(edges[k] <= t < edges[k + 1] for t in w.done_s)
            / (edges[k + 1] - edges[k]) for k in range(5)]


def run(drv_mod, driver, start: int, seconds: float | None = None,
        count: int | None = None) -> Window:
    """The driver module's ``window`` where it has one, else the closed
    loop over ``driver.launch`` and ``driver.collect``."""
    loop = getattr(drv_mod, "window", None)
    if loop is not None:
        return loop(driver, start, seconds=seconds, count=count)
    return closed_loop(driver.launch, driver.collect, start,
                       seconds=seconds, count=count)


def p95_ms(w: Window) -> float:
    """The 95th percentile of every item's latency in the window (ms)."""
    lat = sorted(w.latency_s)
    p95 = statistics.quantiles(lat, n=20, method="inclusive")[18] \
        if len(lat) > 1 else lat[0]
    return 1e3 * p95
