"""Device-resident frame cache: a decoded frame crosses host -> device once.

Counterpart of ``rdpn6d_tpu/data/device_cache.py``. On small and medium
splits trained for many epochs (LM: a few thousand frames, 160 epochs) the
same frames would cross the host-device link every epoch; this cache keeps
them on the trainer's device, keyed by their source path, bytes-capped
with LRU eviction. Per step only the frames not yet resident are uploaded;
the batch's frame stack is put together on the device. Augmentation is
untouched: a private frame (key ``None``) always streams, and DZI happens
downstream in ``preprocess_rois_grouped``.

Raw depth is uploaded as its 16-bit pattern (an ``int16`` view, half the
bytes of int32) and widened to int32 on the device, since PyTorch's
``uint16`` supports few operations.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

__all__ = ["DeviceFrameCache", "upload_frame", "widen_depth"]


def upload_frame(frame: dict, device: torch.device) -> dict:
    """One frame's numpy tensors on ``device``; uint16 depth as the int16
    view of its bits. The decoder's cached arrays are read-only, and torch
    takes only writable ones: those are copied on the host first."""
    out = {}
    for k, v in frame.items():
        a = np.asarray(v)
        if a.dtype == np.uint16:
            a = a.view(np.int16)
        if not (a.flags.writeable and a.flags.c_contiguous):
            a = np.array(a, order="C")
        out[k] = torch.from_numpy(a).to(device)
    return out


def widen_depth(frames: dict) -> dict:
    """Uploaded frames with their raw depth widened to int32 (the uint16
    value), as ``preprocess_rois_grouped`` reads it."""
    out = dict(frames)
    if "depth_raw" in out and out["depth_raw"].dtype == torch.int16:
        out["depth_raw"] = out["depth_raw"].to(torch.int32) & 0xFFFF
    return out


def _nbytes(dev: dict) -> int:
    return sum(v.numel() * v.element_size() for v in dev.values())


class DeviceFrameCache:
    """Bytes-capped device-side LRU of per-frame tensor dicts.

    ``stack(slots)`` takes the loader's ``frame_slots``, a list of
    ``(key | None, frame_numpy_dict)``, and returns the stacked frames
    dict ``preprocess_rois_grouped`` expects, uploading only the slots
    that are not resident. Repeated keys within a batch (the frame-bucket
    padding repeats the last frame) hit the cache."""

    def __init__(self, cap_bytes: int, device: str | torch.device = "cuda"):
        if cap_bytes <= 0:
            raise ValueError("DeviceFrameCache needs a positive byte cap")
        self.cap = int(cap_bytes)
        self.device = torch.device(device)
        self._cache: OrderedDict[str, dict] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.private = 0        # private frames streamed (counted as misses)

    def _insert(self, key: str, dev: dict) -> None:
        nb = _nbytes(dev)
        if nb > self.cap:       # a frame larger than the cap streams
            return
        while self._bytes + nb > self.cap and self._cache:
            _, old = self._cache.popitem(last=False)
            self._bytes -= _nbytes(old)
        self._cache[key] = dev
        self._bytes += nb

    def stack(self, slots: list) -> dict:
        devs = []
        for key, frame in slots:
            if key is None:
                # a private frame: its pixels differ per visit
                self.misses += 1
                self.private += 1
                devs.append(upload_frame(frame, self.device))
            elif key in self._cache:
                self.hits += 1
                self._cache.move_to_end(key)
                devs.append(self._cache[key])
            else:
                self.misses += 1
                dev = upload_frame(frame, self.device)
                self._insert(key, dev)
                devs.append(dev)
        return widen_depth({k: torch.stack([d[k] for d in devs])
                            for k in devs[0]})

    @property
    def resident_bytes(self) -> int:
        return self._bytes

    def stats(self) -> dict[str, float]:
        """Hit rate, resident MB and frames, for the metric writers: a
        thrashing cache (a cap too small for the epoch's frames) looks
        like a healthy one in the loss curve."""
        total = self.hits + self.misses
        return {
            "frame_cache_hit_rate": self.hits / total if total else 0.0,
            "frame_cache_resident_mb": self._bytes / (1 << 20),
            "frame_cache_frames": float(len(self._cache)),
        }

    def __len__(self) -> int:
        return len(self._cache)

    def __contains__(self, key) -> bool:
        return key in self._cache
