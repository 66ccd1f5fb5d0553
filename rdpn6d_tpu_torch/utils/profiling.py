"""Profiling helpers.

Counterpart of ``rdpn6d_tpu/utils/profiling.py``: ``trace`` captures a
``torch.profiler`` trace of a region (CPU activity, and CUDA where a card
is present) as a Chrome trace, viewable in Perfetto or chrome://tracing.
``span`` names a region of the program inside such a trace: the
preprocessing (``rdpn.pre``), the eval step (``rdpn.eval``), the model's
trunk, head and PnP (``rdpn.model.*``) and the train step's forward,
losses, backward and optimizer (``rdpn.step.*``) each show as a range on
the host's timeline, on the clock of the kernels they launch. With no
profiler recording a span is one flag test.
``count_flops`` and ``bf16_peak_flops`` give the ``bench_*`` tools their
MFU: the convolution and matrix-product FLOPs that
``torch.utils.flop_counter`` counts, over the card's dense bf16 peak.
"""

from __future__ import annotations

import contextlib
import os

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


SPAN_PREFIX = "rdpn."
# what ``span`` returns while no profiler records: one object, reused
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("step.loss"): ...``: while a ``torch.profiler`` profile
    records (``trace``, ``main --profile``), a range ``rdpn.<name>`` on
    the host's timeline; otherwise a shared no-op context that records
    and allocates nothing. The ranges of one call nest under that call's
    top-level span (``rdpn.pre``, ``rdpn.eval``, ``rdpn.step``)."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


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
