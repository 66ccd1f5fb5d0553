"""What the per-layer metric files read from a traced run.

``Run`` carries the traced sub-window (``trace.Trace``), the number of
items it held, the untraced window's rate, the FLOPs of one item as the
reference counts them, and the shapes of each kernel's launches in the
traced items (for the roofline formulas). Each function returns None
where the run holds nothing to read, and the harness then leaves the
metric out.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field

# NVIDIA's data sheet for the H100 SXM, dense, at 700 W
BF16_PEAK_FLOPS = 989e12


@dataclass
class Run:
    trace: object                 # trace.Trace
    traced_items: int
    items_per_s: float            # the untraced window's rate
    flops_per_item: float         # the reference's count
    dispatch_s: list              # host seconds to launch each item
    kernel_shapes: dict = field(default_factory=dict)  # kernel -> [shapes]
    manifest: object = None       # manifest.Manifest, for the rooflines


def range_device_ms(run: Run, name: str) -> float | None:
    if not run.traced_items:
        return None
    s = run.trace.range_seconds(name)
    return 1e3 * s / run.traced_items if s > 0 else None


def step_mfu_pct(run: Run) -> float | None:
    if not run.flops_per_item or not run.items_per_s:
        return None
    return 100.0 * run.flops_per_item * run.items_per_s / BF16_PEAK_FLOPS


def host_dispatch_ms(run: Run) -> float | None:
    return 1e3 * statistics.median(run.dispatch_s) if run.dispatch_s \
        else None


def launches_per_item(run: Run) -> float | None:
    if not run.traced_items or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.traced_items


def device_idle_pct(run: Run) -> float | None:
    if run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def roofline_pct(run: Run, kernel: str) -> float | None:
    """The kernel's least time at its traced launches' shapes
    (``rooflines/<kernel>.py``) over its traced device time."""
    shapes = run.kernel_shapes.get(kernel, [])
    if not shapes or run.manifest is None:
        return None
    formula = run.manifest.roofline(kernel)
    seconds, n = run.trace.kernel_seconds(formula.KERNEL)
    # silent where the kernel is off the path, or launched otherwise than
    # the formula's one launch a recorded shape
    if n == 0 or seconds <= 0 or n != len(shapes):
        return None
    return 100.0 * sum(formula.bound_s(s) for s in shapes) / seconds
