"""Metric writers: console, JSON lines, TensorBoard.

Counterpart of ``rdpn6d_tpu/engine/writers.py`` (the reference's
EventStorage writer trio): ``MetricBuffer`` keeps the latest sample of each
metric, ``ConsoleWriter`` logs ETA, s/it, lr and the losses,
``JsonWriter`` appends ``metrics.json`` lines with the JAX package's keys
(``iteration`` and the metrics), ``TensorboardWriter`` writes scalars,
histograms and image panels through ``torch.utils.tensorboard`` where that
imports (it needs the ``tensorboard`` package), and nothing elsewhere, as
the JAX package writes only where ``tensorflow`` imports. In a process
group the writers of ranks other than 0 write nothing (the JAX package's
``is_main``): every rank holds the same global metrics.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any

import numpy as np

from ..parallel.mesh import is_main

logger = logging.getLogger("rdpn6d")


class MetricBuffer:
    """The latest sample of each metric (samples arrive at log events
    only, so no window or history is kept)."""

    def __init__(self):
        self._last: dict[str, float] = {}

    def update(self, metrics: dict[str, float]) -> None:
        for k, v in metrics.items():
            self._last[k] = float(v)

    def latest(self, key: str) -> float:
        return self._last.get(key, 0.0)

    def keys(self):
        return self._last.keys()


class ConsoleWriter:
    """ETA / s/it / lr / losses line, timed from the first write."""

    def __init__(self, max_iter: int):
        self.enabled = is_main()
        self.max_iter = max_iter
        self._start = time.time()
        self._start_iter: int | None = None

    def write(self, step: int, buf: MetricBuffer, lr: float) -> None:
        if not self.enabled:
            return
        if self._start_iter is None:
            self._start_iter = step
            self._start = time.time()
        done = max(step - self._start_iter, 1)
        rate = (time.time() - self._start) / done
        eta = rate * (self.max_iter - step)
        losses = "  ".join(
            f"{k}: {buf.latest(k):.4f}" for k in sorted(buf.keys())
            if k.startswith("loss") or k == "total_loss")
        logger.info(
            f"iter {step}/{self.max_iter}  eta {eta / 60:.1f}m  "
            f"{rate:.3f}s/it  lr {lr:.2e}  {losses}")


class JsonWriter:
    """Appends one ``{"iteration": step, metric: value, ...}`` line a log
    event to ``path``."""

    def __init__(self, path: str):
        self._f = None
        if is_main():
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._f = open(path, "a")

    def write(self, step: int, metrics: dict[str, Any]) -> None:
        if self._f is None:
            return
        row = {"iteration": step}
        row.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


class TensorboardWriter:
    """Scalars, histograms and image panels under ``logdir`` through
    ``torch.utils.tensorboard``; every write is a no-op where it does not
    import."""

    def __init__(self, logdir: str):
        self._writer = None
        if not is_main():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._writer = SummaryWriter(logdir)

    @property
    def enabled(self) -> bool:
        return self._writer is not None

    def write(self, step: int, metrics: dict[str, Any]) -> None:
        if self._writer is None:
            return
        for k, v in metrics.items():
            self._writer.add_scalar(k, float(v), global_step=step)
        self._writer.flush()

    def write_histograms(self, step: int, tensors: dict[str, Any]) -> None:
        """Histograms of name -> array-like (empty ones skipped)."""
        if self._writer is None:
            return
        for k, v in tensors.items():
            arr = np.asarray(v, np.float32).ravel()
            if arr.size:
                self._writer.add_histogram(k, arr, global_step=step)
        self._writer.flush()

    def write_images(self, step: int, images: dict[str, Any]) -> None:
        """Image panels, [H,W,C] float in [0,1] or [H,W]; others are
        min-max scaled (a constant out-of-range image shows saturated)."""
        if self._writer is None:
            return
        for k, img in images.items():
            arr = np.asarray(img, np.float32)
            if arr.ndim == 2:
                arr = arr[..., None]
            lo, hi = arr.min(), arr.max()
            if hi > 1.0 or lo < 0.0:
                arr = (arr - lo) / (hi - lo) if hi > lo \
                    else np.ones_like(arr)
            self._writer.add_image(k, arr, global_step=step,
                                   dataformats="HWC")
        self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
