"""Host-side decoding of split records: the eval frames and the grouped
train batches.

Counterpart of ``rdpn6d_tpu/data/loader.py``: ``SkipRecord``, the
``_BytesLRU`` of decoded frames, the ``RecordDecoder`` (frames for eval;
in train mode also the per-instance compact GT of ``decode_roi_compact``),
``load_train_records`` and the frame-grouped ``train_group_iterator``, whose
batches are byte for byte the JAX package's for the same records and seed
wherever the JAX package's frame key, (scene_id, im_id), names one image
file (the port groups by the file; ROADMAP queue 3).
Images are read with the port's own PNG codec (``data/png.py``), not
OpenCV. Not ported, and refused: background replacement
(``data.change_bg_prob > 0``: a JPEG reader and a resize) and the flat,
per-instance train path (``train_frame_iterator``), ROADMAP queue 1 item 10.
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
from collections import Counter, OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np

from ..config import Config
from .bop import build_split_records, get_split
from .png import imread_mask, imread_rgb, imread_unchanged
from .refs import get_ref
from .sampler import InfiniteSampler, RepeatFactorSampler, frame_repeat_factors


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
    """Record dict -> the frame tensors of the grouped paths, and in train
    mode each instance's compact GT (``decode_roi_compact``). ``assets``
    (a ``ClassAssets``) is needed for the train decode only."""

    def __init__(self, cfg: Config, assets: Any = None, train: bool = False,
                 seed: int = 0):
        if train and cfg.data.change_bg_prob > 0:
            raise NotImplementedError(
                "data.change_bg_prob > 0: background replacement needs a "
                "JPEG reader and a resize, which the port does not have "
                "(ROADMAP queue 1 item 10)")
        self.cfg = cfg
        self.assets = assets
        self.seed = seed
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

    def _record_rng(self, rec: dict[str, Any],
                    visit: int = 0) -> np.random.RandomState:
        """The per-(record, visit) stream of the train-time draws: the same
        whatever the decode threads' interleaving, re-rolled every visit.
        Background replacement, which is not ported, is what draws from
        it."""
        mix = (self.seed * 1_000_003
               + int(rec.get("scene_id", 0)) * 10_007
               + int(rec.get("im_id", 0)) * 101
               + int(rec.get("inst_idx", 0))
               + int(visit) * 97_002_121) & 0x7FFFFFFF
        return np.random.RandomState(mix)

    @staticmethod
    def _depth_fallback_xyz(depth: np.ndarray, rec: dict[str, Any],
                            mask_visib: np.ndarray | None) -> np.ndarray:
        """Model-frame coords of the visible surface from measured depth:
        xyz = R^T (backproject(depth) - t), zeroed outside (depth valid) &
        mask; for records without an xyz crop on disk."""
        H, W = depth.shape
        K, R, t = rec["K"], rec["R"], rec["t"]
        u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                           np.arange(H, dtype=np.float32))
        pc = np.stack([(u - K[0, 2]) * depth / K[0, 0],
                       (v - K[1, 2]) * depth / K[1, 1], depth], -1)
        xyz = (pc - t) @ R  # = R^T (p - t)
        m = depth > 1e-6
        if mask_visib is not None:
            m = m & (mask_visib > 0)
        return xyz * m[..., None]

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

    def _xyz_info(self, path: str) -> dict[str, np.ndarray]:
        """An ``-xyz.pkl`` crop (the crop and its inclusive xyxy box, in
        its stored dtype), through the frame LRU."""
        def load() -> dict[str, np.ndarray]:
            with open(path, "rb") as f:
                info = pickle.load(f)
            return {"xyxy": np.asarray(info["xyxy"], np.int32),
                    "crop": np.asarray(info["xyz_crop"])}

        return load() if self._frame_cache is None \
            else self._frame_cache.get(("xyz", path), load)

    def _xyz_full(self, path: str, H: int, W: int) -> np.ndarray:
        """An xyz crop pasted into a fresh float32 full-frame map."""
        info = self._xyz_info(path)
        x1, y1, x2, y2 = (int(v) for v in info["xyxy"])
        full = np.zeros((H, W, 3), np.float32)
        full[y1:y2 + 1, x1:x2 + 1] = info["crop"].astype(np.float32)
        return full

    def _bbox_xyxy(self, rec: dict[str, Any],
                   mask_visib: np.ndarray | None) -> np.ndarray:
        bbox = rec.get("bbox_visib")
        if bbox is None:
            if mask_visib is None:
                raise SkipRecord(f"no bbox and no mask: {rec['rgb_path']}")
            ys, xs = np.nonzero(mask_visib)
            if xs.size == 0:  # fully occluded / invalid depth everywhere
                raise SkipRecord(
                    f"empty visibility mask: {rec['rgb_path']}")
            return np.array([xs.min(), ys.min(), xs.max(), ys.max()],
                            np.float32)
        bbox = np.asarray(bbox, np.float32)
        if bbox.shape[0] == 4 and rec.get("bbox_mode", "xywh") == "xywh":
            bbox = np.array([bbox[0], bbox[1], bbox[0] + bbox[2],
                             bbox[1] + bbox[3]], np.float32)
        return bbox

    def _roi_assets(self, rec: dict[str, Any]) -> dict[str, np.ndarray]:
        proj = rec["K"] @ rec["t"]
        a = self.assets.for_obj(rec["obj_id"])
        n_points = self.cfg.loss.num_pm_points
        return {
            "K": rec["K"].astype(np.float32),
            "gt_rot": rec["R"].astype(np.float32),
            "gt_trans": rec["t"].astype(np.float32),
            "fps": a["fps"].astype(np.float32),
            "extent": a["extent"].astype(np.float32),
            "centroid_2d": (proj[:2] / proj[2]).astype(np.float32),
            "roi_points": a["points"][:n_points].astype(np.float32),
            "sym_rots": a["sym_rots"].astype(np.float32),
            "roi_cls": np.int32(rec["cls_idx"]),
        }

    def read_frame(self, rec: dict[str, Any]) -> dict[str, np.ndarray]:
        """One frame's shared tensors in compact dtypes: uint8 RGB, raw
        uint16 depth and its factor, K. Decoded once per (scene, im) by the
        grouped paths."""
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

    def decode_roi_compact(
        self, rec: dict[str, Any], frame: dict[str, np.ndarray],
        visit: int = 0, ship_xyz: bool = True,
    ) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray] | None]:
        """One instance's compact per-ROI tensors against a shared frame.

        Returns (roi, private_frame): ``roi`` carries what the train labels
        need on the ROI axis: ``mask_packed`` uint8 (visib bit 0, trunc bit
        1), the GT ``xyz`` in float16 (left out when ``ship_xyz`` is
        false: the device derives coords from the depth surface), the box,
        the pose and the class's assets. With ``data.ship_crops`` the maps
        are the xyz map's own nonzero box, with its top-left in
        ``xyz_offset``, instead of full frames: bit-exact, since the labels
        multiply every mask by xyz != 0, which is zero outside that box.
        ``private_frame`` is always None here: only background
        replacement, which is not ported, gives an instance a frame of its
        own. ``visit`` numbers the record's visits (its draws' stream)."""
        H, W = rec["height"], rec["width"]
        mask_visib = self._mask_visib(rec)
        ship_crops = bool(self.cfg.data.ship_crops)
        xyz16 = None
        xyz_box = None  # inclusive (x1, y1, x2, y2) covering xyz != 0
        if ship_xyz:
            if rec.get("xyz_path") and os.path.exists(rec["xyz_path"]):
                info = self._xyz_info(rec["xyz_path"])
                x1, y1, x2, y2 = (int(v) for v in info["xyxy"])
                xyz_box = (x1, y1, x2, y2)
                if ship_crops:
                    xyz16 = np.ascontiguousarray(
                        info["crop"].astype(np.float16))
                else:
                    xyz16 = self._xyz_full(
                        rec["xyz_path"], H, W).astype(np.float16)
                if mask_visib is None:
                    mask_visib = np.zeros((H, W), np.float32)
                    mask_visib[y1:y2 + 1, x1:x2 + 1] = (
                        np.abs(info["crop"].astype(np.float32)).sum(-1)
                        > 0)
            else:
                depth = frame["depth_raw"].astype(np.float32) \
                    / float(frame["depth_factor"])
                xyz16 = self._depth_fallback_xyz(
                    depth, rec, mask_visib).astype(np.float16)
                if mask_visib is None:
                    mask_visib = (np.abs(xyz16.astype(np.float32)).sum(-1)
                                  > 0).astype(np.float32)
                if ship_crops:
                    # a float compare, not a bit test: the masked multiply
                    # leaves -0.0 at background pixels, which is xyz == 0
                    # on the device too
                    nz = xyz16 != 0
                    nz_y = np.flatnonzero(np.any(nz, axis=(1, 2)))
                    nz_x = np.flatnonzero(np.any(nz, axis=(0, 2)))
                    if nz_y.size:
                        xyz_box = (int(nz_x[0]), int(nz_y[0]),
                                   int(nz_x[-1]), int(nz_y[-1]))
                    else:  # fully occluded/invalid: 1px zero crop
                        xyz_box = (0, 0, 0, 0)
                    x1, y1, x2, y2 = xyz_box
                    xyz16 = np.ascontiguousarray(
                        xyz16[y1:y2 + 1, x1:x2 + 1])
        if mask_visib is None:
            # a maskless record without ship_xyz: the visible surface is
            # the valid-depth pixels, cropped to the ROI downstream
            mask_visib = (frame["depth_raw"] > 0).astype(np.float32)

        bbox = self._bbox_xyxy(rec, mask_visib)
        visib8 = (mask_visib > 0).astype(np.uint8)
        packed = visib8 | (visib8 << 1)     # trunc = visib without bg aug
        if xyz_box is not None and ship_crops:
            x1, y1, x2, y2 = xyz_box
            packed = np.ascontiguousarray(packed[y1:y2 + 1, x1:x2 + 1])
        roi = {"bbox": bbox.astype(np.float32), "mask_packed": packed,
               **self._roi_assets(rec)}
        if xyz16 is not None:
            roi["xyz"] = xyz16
            if xyz_box is not None and ship_crops:
                roi["xyz_offset"] = np.asarray(xyz_box[:2], np.float32)
        return roi, None


def _stack(samples: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _pad_roi_crops(rois: list[dict[str, np.ndarray]],
                   pad_bucket: int) -> None:
    """Zero-pad per-ROI GT crops (``xyz`` + ``mask_packed`` shipped with an
    ``xyz_offset``) to the batch's largest height and width, each rounded
    up to ``pad_bucket``. Rectangular, not square: one wide object would
    otherwise inflate every crop of the batch. The labels treat pixels
    outside a crop as zero either way. In place."""
    if not rois or "xyz_offset" not in rois[0]:
        return
    ph = max(r["xyz"].shape[0] for r in rois)
    pw = max(r["xyz"].shape[1] for r in rois)
    ph = -(-ph // pad_bucket) * pad_bucket
    pw = -(-pw // pad_bucket) * pad_bucket
    for r in rois:
        h, w = r["xyz"].shape[:2]
        if h == ph and w == pw:
            continue
        xyz = np.zeros((ph, pw, 3), r["xyz"].dtype)
        xyz[:h, :w] = r["xyz"]
        mp = np.zeros((ph, pw), r["mask_packed"].dtype)
        mp[:h, :w] = r["mask_packed"]
        r["xyz"], r["mask_packed"] = xyz, mp


def load_train_records(cfg: Config, split_names: str | list[str],
                       cache_dir: str | None = None) -> list[dict]:
    """The visibility-filtered records of one or more train splits,
    concatenated in order."""
    if isinstance(split_names, str):
        split_names = [split_names]
    records: list[dict] = []
    for name in split_names:
        records.extend(build_split_records(
            get_split(name), cache_dir=cache_dir, flatten=True))
    if cfg.data.filter_visib_thr > 0:
        records = [r for r in records
                   if r.get("visib_fract", 1.0) >= cfg.data.filter_visib_thr]
    if not records:
        raise RuntimeError(f"splits {split_names} produced no records")
    return records


def default_num_workers() -> int:
    """Decode threads: one a core but one, at most 8; 1 on one core."""
    n = os.cpu_count() or 1
    return max(1, min(8, n - 1)) if n > 1 else 1


def train_frame_iterator(*args, **kwargs):
    raise NotImplementedError("the flat (per-instance) train path, "
                              "data.grouped_train=false, is not ported "
                              "(ROADMAP queue 1 item 10)")


def train_group_iterator(cfg: Config, split_name: str | list[str],
                         decoder: RecordDecoder | None = None,
                         batch_size: int | None = None,
                         seed: int = 0,
                         cache_dir: str | None = None,
                         num_prefetch: int = 2,
                         num_workers: int | None = None,
                         frame_bucket: int | None = None,
                         yield_keys: bool = False) -> Iterator[dict]:
    """Infinite iterator of frame-deduplicated compact train batches for
    ``preprocess_rois_grouped(train=True)``.

    Yields ``{"frames": {...}, "rois": {...}}``: frames carry uint8 RGB,
    raw uint16 depth, its factor and K, one slot per distinct frame
    (padded to a multiple of ``frame_bucket`` by repeating the last);
    rois carry each instance's compact GT (float16 xyz or none, packed
    uint8 masks) and its ``frame_idx``. ``yield_keys`` replaces the
    stacked ``"frames"`` with ``"frame_slots"``, a list of ``(key,
    frame)`` for ``data/device_cache.DeviceFrameCache``. Sampling is per
    frame, shuffled: every instance of a drawn frame enters the batch, and
    a batch is cut at exactly ``batch_size`` ROIs.

    A pool of ``num_workers`` threads decodes frames (zlib releases the
    GIL); results are taken in sampler order, so the batches are the same
    whatever the number of workers. An exception in the producer is raised
    in the consumer. Closing the iterator stops the producer."""
    names = [split_name] if isinstance(split_name, str) else list(split_name)
    records = load_train_records(cfg, names, cache_dir=cache_dir)
    if decoder is None:
        from .assets import load_class_assets

        split = get_split(names[0])
        assets = load_class_assets(
            get_ref(split.ref_name), cfg.head.num_regions,
            cfg.loss.num_pm_points,
            objs=list(split.objs) if split.objs else None)
        decoder = RecordDecoder(cfg, assets, train=True)
    bs = batch_size or cfg.solver.ims_per_batch

    # a frame is an image file: lm_13_train's and lm_imgn's records share
    # scene_id = obj_id and overlapping im_ids, so the JAX package's
    # (scene_id, im_id) key would merge an lm_imgn instance into an LM
    # frame (ROADMAP queue 3); on splits without such collisions both
    # keys make the same groups in the same order
    by_frame: dict[str, list[int]] = {}
    for i, r in enumerate(records):
        by_frame.setdefault(r["rgb_path"], []).append(i)
    frame_groups = list(by_frame.values())

    # ship xyz if ANY record has a GT crop on disk; a split with none
    # derives its coords from the depth surface on the device
    ship_xyz = any(
        r.get("xyz_path") and os.path.exists(r["xyz_path"])
        for r in records)

    if frame_bucket is None:
        frame_bucket = max(1, min(8, bs))

    if cfg.data.repeat_factor_thresh > 0:
        reps = frame_repeat_factors(
            [[records[i]["cls_idx"] for i in g] for g in frame_groups],
            cfg.data.repeat_factor_thresh)
        sampler: InfiniteSampler = RepeatFactorSampler(repeat_factors=reps,
                                                       seed=seed)
    else:
        sampler = InfiniteSampler(len(frame_groups), seed=seed)

    if num_workers is None:
        num_workers = default_num_workers()

    q: queue.Queue = queue.Queue(maxsize=num_prefetch)
    stop = threading.Event()

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def decode_group(rec_idxs, visit):
        """One frame and all its instances -> (key, frame, [roi])."""
        base = records[rec_idxs[0]]
        try:
            frame = decoder.read_frame(base)
        except (FileNotFoundError, OSError):
            return None
        rois = []
        for ri in rec_idxs:
            try:
                roi, _ = decoder.decode_roi_compact(
                    records[ri], frame, visit=visit, ship_xyz=ship_xyz)
            except (FileNotFoundError, OSError, SkipRecord):
                continue
            rois.append(roi)
        if not rois:
            return None
        return base["rgb_path"], frame, rois

    def produce(ex: ThreadPoolExecutor) -> None:
        idx_iter = iter(sampler)
        visits: Counter = Counter()

        def submit():
            gi = next(idx_iter)
            n = visits[gi]
            visits[gi] += 1
            return ex.submit(decode_group, frame_groups[gi], n)

        futs: deque = deque(submit() for _ in range(2 * num_workers))
        frames_l: list[dict] = []
        keys_l: list[str] = []
        rois_l: list[dict] = []
        while not stop.is_set():
            fut = futs.popleft()
            futs.append(submit())
            group = fut.result()
            if group is None:
                continue
            key, frame, rois = group
            fidx = len(frames_l)
            frames_l.append(frame)
            keys_l.append(key)
            for roi in rois[:bs - len(rois_l)]:
                rois_l.append({**roi, "frame_idx": np.int32(fidx)})
            if len(rois_l) == bs:
                F = len(frames_l)
                Fpad = min(-(-F // frame_bucket) * frame_bucket, bs)
                while len(frames_l) < Fpad:
                    frames_l.append(frames_l[-1])
                    keys_l.append(keys_l[-1])
                _pad_roi_crops(rois_l, int(cfg.data.crop_pad))
                batch = {"rois": _stack(rois_l)}
                if yield_keys:
                    batch["frame_slots"] = list(zip(keys_l, frames_l))
                else:
                    batch["frames"] = _stack(frames_l)
                put(batch)
                frames_l, keys_l, rois_l = [], [], []

    def producer() -> None:
        ex = ThreadPoolExecutor(max_workers=num_workers,
                                thread_name_prefix="decode")
        try:
            produce(ex)
        except BaseException as e:  # surface in the consumer, never hang
            put(e)
        finally:
            ex.shutdown(wait=True, cancel_futures=True)

    th = threading.Thread(target=producer, daemon=True,
                          name="train_group_iterator")
    th.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise RuntimeError("data loader producer thread failed") \
                    from item
            yield item
    finally:
        stop.set()
        th.join()
