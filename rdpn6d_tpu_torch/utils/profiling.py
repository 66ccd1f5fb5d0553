"""Profiling and timing helpers.

Counterpart of ``rdpn6d_tpu/utils/profiling.py``: ``trace`` captures a
``torch.profiler`` trace of a region (CPU activity, and CUDA where a card
is present) as a Chrome trace, viewable in Perfetto or chrome://tracing;
``annotate`` names a region inside it; ``StepTimer`` keeps wall-clock
stats per named phase, synchronizing the card on the tensors the block
yields to it, where the JAX version blocks on its arrays.
``count_flops`` and ``bf16_peak_flops`` give the ``bench_*`` tools their
MFU: the convolution and matrix-product FLOPs that
``torch.utils.flop_counter`` counts, over the card's dense bf16 peak.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace("/tmp/profile"): step(...)`` writes
    ``<logdir>/trace.json`` (rank r > 0 of a process group:
    ``trace.rank<r>.json``)."""
    from torch.profiler import ProfilerActivity, profile

    from ..parallel import mesh

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    r = mesh.rank()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace.rank{r}.json" if r else "trace.json"))


def annotate(name: str):
    """A named region inside a trace (a range on the timeline)."""
    return torch.profiler.record_function(name)


def _sync(value) -> None:
    """Wait for the card's work on every CUDA tensor in ``value`` (a
    tensor, or a list, tuple or dict of them)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _sync(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _sync(v)


class StepTimer:
    """Blocking wall-clock stats per named phase."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def measure(self, name: str):
        """``with timer.measure("step") as sync: out = f(x); sync(out)``.

        Call the yielded ``sync`` on tensors produced INSIDE the block to
        include their queued device work in the measurement. Accounting
        runs even if the body raises."""
        pending = []
        t0 = time.perf_counter()
        try:
            yield pending.append
        finally:
            for r in pending:
                _sync(r)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}

    def report(self) -> str:
        return "  ".join(f"{k}: {v * 1000:.2f}ms"
                         for k, v in sorted(self.summary().items()))


# dense (no sparsity) bf16 tensor-core peak by the card's name, as
# nvidia-smi and torch.cuda.get_device_name give it; NVIDIA H100 Tensor
# Core GPU datasheet (H100 SXM5: 1,979 TFLOP/s with sparsity)
BF16_PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}


def bf16_peak_flops(device: str | torch.device) -> float | None:
    """The dense bf16 peak FLOP/s of ``device``'s card, or None on the
    CPU or on a card missing from ``BF16_PEAK_FLOPS``."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return BF16_PEAK_FLOPS.get(torch.cuda.get_device_name(device))


def count_flops(fn) -> float:
    """The FLOPs of what ``fn()`` runs, as ``torch.utils.flop_counter``
    counts them: convolutions and matrix products, forward and backward
    (elementwise work, norms and the port's own kernels count 0)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())
