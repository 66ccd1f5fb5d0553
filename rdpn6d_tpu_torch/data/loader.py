"""Host-side decoding of split records: the eval half.

Counterpart of ``rdpn6d_tpu/data/loader.py``'s ``SkipRecord``,
``_BytesLRU``, image readers and the frame-level ``RecordDecoder`` methods
the evaluation path calls (``read_frame``, ``_decoded_frame``,
``_mask_visib``). Images are read with the port's own PNG codec
(``data/png.py``), not OpenCV. The train iterators, the per-instance train
decode and augmentation are not ported (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any

import numpy as np

from ..config import Config
from .png import imread_mask, imread_rgb, imread_unchanged


class SkipRecord(Exception):
    """A record that cannot produce a sample (fully occluded instance,
    empty mask): callers skip it like an unreadable file."""


class _BytesLRU:
    """Bytes-capped thread-safe LRU of decoded frames. Cached arrays are
    read-only; every consumer copies (astype, np.stack)."""

    def __init__(self, cap_bytes: int):
        self.cap = cap_bytes
        self._d: OrderedDict[Any, Any] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    @staticmethod
    def _nbytes(val) -> int:
        if isinstance(val, dict):
            return sum(v.nbytes for v in val.values()
                       if isinstance(v, np.ndarray))
        return val.nbytes

    def get(self, key, decode):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
        val = decode()      # outside the lock: decodes stay parallel
        arrs = val.values() if isinstance(val, dict) else (val,)
        for a in arrs:
            if isinstance(a, np.ndarray):
                a.flags.writeable = False
        with self._lock:
            if key not in self._d:
                self._d[key] = val
                self._bytes += self._nbytes(val)
                while self._bytes > self.cap and len(self._d) > 1:
                    _, old = self._d.popitem(last=False)
                    self._bytes -= self._nbytes(old)
        return val


def _imread_rgb(path: str) -> np.ndarray:
    return imread_rgb(path).astype(np.float32)


def _imread_depth(path: str, depth_factor: float) -> np.ndarray:
    return imread_unchanged(path).astype(np.float32) / depth_factor


def _imread_mask(path: str) -> np.ndarray:
    return (imread_mask(path) > 0).astype(np.float32)


class RecordDecoder:
    """Record dict -> the frame tensors of the grouped eval path."""

    def __init__(self, cfg: Config, train: bool = False):
        if train:
            raise NotImplementedError(
                "RecordDecoder(train=True): the train decode is not ported "
                "(ROADMAP queue 1 item 10)")
        cap_mb = int(cfg.data.frame_cache_mb)
        self._frame_cache = _BytesLRU(cap_mb << 20) if cap_mb > 0 else None

    def _decoded_frame(self, rec: dict[str, Any]) -> dict[str, np.ndarray]:
        """(rgb uint8, depth as stored) of a record, through the LRU."""
        def decode():
            return {"rgb": imread_rgb(rec["rgb_path"]),
                    "depth_stored": imread_unchanged(rec["depth_path"])}

        if self._frame_cache is None:
            return decode()
        return self._frame_cache.get(rec["rgb_path"], decode)

    def _mask_visib(self, rec: dict[str, Any]) -> np.ndarray | None:
        """Visible-object mask [H, W] float32 from the mask file or a
        YCB-style label image; None when neither is readable. Read
        failures are never cached."""
        cache = self._frame_cache
        mpath = rec.get("mask_visib_path")
        if mpath:
            def load_m() -> np.ndarray:
                return (imread_mask(mpath) > 0).astype(np.uint8)

            try:
                m8 = load_m() if cache is None \
                    else cache.get(("mask", mpath), load_m)
            except FileNotFoundError:
                m8 = None
            if m8 is not None:
                return m8.astype(np.float32)

        lpath = rec.get("label_path")
        if lpath:
            def load_lab() -> np.ndarray:
                return imread_unchanged(lpath)

            try:
                lab = load_lab() if cache is None \
                    else cache.get(("label", lpath), load_lab)
            except FileNotFoundError:
                return None
            return (lab == rec["label_obj_id"]).astype(np.float32)
        return None

    def read_frame(self, rec: dict[str, Any]) -> dict[str, np.ndarray]:
        """One frame's shared tensors in compact dtypes: uint8 RGB, raw
        uint16 depth and its factor, K."""
        base = self._decoded_frame(rec)
        draw = base["depth_stored"]
        if draw.dtype != np.uint16:
            draw = draw.astype(np.uint16)
        return {
            "rgb": base["rgb"],
            "depth_raw": draw,
            "depth_factor": np.float32(rec["depth_factor"]),
            "K": rec["K"].astype(np.float32),
        }


def train_frame_iterator(*args, **kwargs):
    raise NotImplementedError("the train loaders are not ported "
                              "(ROADMAP queue 1 item 10)")


train_group_iterator = train_frame_iterator
