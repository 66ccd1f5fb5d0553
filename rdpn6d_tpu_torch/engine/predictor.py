"""Serving API: RGB-D frames + detections in, 6DoF poses out.

Counterpart of ``rdpn6d_tpu/engine/predictor.py``, with the body of the
JAX package's ``make_eval_step`` inlined. Weights come from the port's
checkpoint directory (``ckpt_dir``: the latest step that
``engine/checkpoint.py`` wrote, as ``main``'s train branch writes them
under ``<output_dir>/ckpt``; where the JAX ``Predictor`` reads orbax),
or from the same ``params_pkl`` the JAX ``Predictor`` reads (a pickle of
the flax ``params``/``batch_stats`` trees as numpy), carried over by
``utils/flax_params.state_dict_from_flax``; a pickle that does not cover
the model is refused, and so is a directory without a checkpoint. With
both, the checkpoint wins, as in the JAX package. Eager PyTorch needs no
fixed batch shape, so a frame's detections go through in chunks of
``batch_size`` without padding.

``test.int8`` serves the W8A8 model (``models/quant.py``); with
``test.int8_static`` its activation scales are calibrated on the first
served batch and then locked, as the JAX ``Predictor`` does (which keeps
"per_channel" only as a truthy flag; the port keeps the mode).

Not ported yet, and refused: the RANSAC-Kabsch refinement
(``test.use_pnp``).
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ..config import Config
from ..data.assets import ClassAssets
from ..data.pipeline import preprocess_rois_grouped
from ..models import RDPN, init_weights
from ..models.quant import calibrate_quant, serving_mode
from ..utils.device import resolve_device
from ..utils.flax_params import state_dict_from_flax


@dataclass
class Detection:
    obj_id: int
    bbox_xyxy: np.ndarray          # [4] float
    score: float = 1.0


class Predictor:
    def __init__(self, cfg: Config, assets: ClassAssets,
                 ckpt_dir: str | None = None,
                 params_pkl: str | None = None,
                 batch_size: int = 16,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None,
                 allow_random_init: bool = False):
        if cfg.test.use_pnp:
            raise NotImplementedError(
                "test.use_pnp: the RANSAC-Kabsch refinement is not ported")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.assets = assets
        self.batch_size = batch_size
        int8, static = serving_mode(cfg)
        model = RDPN(cfg, int8=int8, int8_static=static)
        if params_pkl:
            with open(params_pkl, "rb") as f:
                loaded = pickle.load(f)
            model.load_state_dict(state_dict_from_flax(
                cfg, loaded.get("params", {}), loaded.get("batch_stats", {})))
        if ckpt_dir:
            from ..parallel import TrainState
            from .checkpoint import CheckpointManager

            mgr = CheckpointManager(ckpt_dir)
            if mgr.latest_step() is None:
                raise FileNotFoundError(
                    f"no checkpoint found in {ckpt_dir!r} — a Predictor "
                    "must never silently serve random-init weights")
            # the model only: serving needs no optimizer state
            mgr.restore(TrainState(model=model, optimizer=None))
        elif not params_pkl:
            if not allow_random_init:
                raise ValueError(
                    "Predictor requires ckpt_dir or params_pkl (refusing to "
                    "serve random-init weights); pass "
                    "allow_random_init=True for smoke tests")
            init_weights(model, torch.Generator().manual_seed(0))
        # Int8Conv keeps its weight in float32 under the cast
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self._needs_calibration = bool(int8 and static)

    @torch.no_grad()
    def predict(self, rgb: np.ndarray, depth: np.ndarray, K: np.ndarray,
                detections: Sequence[Detection]) -> list[dict[str, Any]]:
        """One frame, any number of detections -> [{obj_id, R, t, score}]."""
        if not detections:
            return []
        dev = self.device
        # rgb goes over in its own dtype (uint8 welcome); the crop casts
        frames = {
            "rgb": torch.as_tensor(np.asarray(rgb)[None]).to(dev),
            "depth": torch.as_tensor(
                np.asarray(depth, np.float32)[None]).to(dev),
            "K": torch.as_tensor(np.asarray(K, np.float32)[None]).to(dev),
        }
        out_all: list[dict[str, Any]] = []
        bs = self.batch_size
        for lo in range(0, len(detections), bs):
            dets = list(detections[lo:lo + bs])
            assets = [self.assets.for_obj(d.obj_id) for d in dets]

            def stack(key):
                return torch.as_tensor(np.stack(
                    [a[key] for a in assets]).astype(np.float32)).to(dev)

            rois = {
                "frame_idx": torch.zeros(len(dets), dtype=torch.long,
                                         device=dev),
                "bbox": torch.as_tensor(np.stack(
                    [np.asarray(d.bbox_xyxy, np.float32) for d in dets]
                )).to(dev),
                "fps": stack("fps"),
                "extent": stack("extent"),
                "roi_cls": torch.as_tensor(
                    [self.assets.full_idx(d.obj_id) for d in dets],
                    dtype=torch.long).to(dev),
            }
            batch = preprocess_rois_grouped(self.cfg, frames, rois)
            if self._needs_calibration:
                # static int8: the scales come from the first served batch.
                # The JAX Predictor pads the batch by repeating its last
                # detection; an absmax cannot change by repeats.
                calibrate_quant(self.model, [batch])
                self._needs_calibration = False
            out = self.model(batch)
            R = out["rot_ego"].cpu().numpy()
            t = out["trans"].cpu().numpy()
            for i, d in enumerate(dets):
                out_all.append({"obj_id": d.obj_id, "R": R[i], "t": t[i],
                                "score": d.score})
        return out_all
