"""Serving API: RGB-D frames + detections in, 6DoF poses out.

Counterpart of ``rdpn6d_tpu/engine/predictor.py``, with the body of the
JAX package's ``make_eval_step`` inlined. Weights come from the same
``params_pkl`` the JAX ``Predictor`` reads (a pickle of the flax
``params``/``batch_stats`` trees as numpy), carried over by
``utils/flax_params.state_dict_from_flax``; a pickle that does not cover
the model is refused. Eager PyTorch needs no fixed batch shape, so a
frame's detections go through in chunks of ``batch_size`` without padding.

Not ported yet, and refused: orbax checkpoints (``ckpt_dir``), int8 serving
(``test.int8``) and the RANSAC-Kabsch refinement (``test.use_pnp``).
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
from ..utils.device import resolve_device
from ..utils.flax_params import state_dict_from_flax


@dataclass
class Detection:
    obj_id: int
    bbox_xyxy: np.ndarray          # [4] float
    score: float = 1.0


class Predictor:
    def __init__(self, cfg: Config, assets: ClassAssets,
                 params_pkl: str | None = None,
                 batch_size: int = 16,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None,
                 allow_random_init: bool = False):
        if cfg.test.int8:
            raise NotImplementedError(
                f"test.int8={cfg.test.int8!r}: int8 serving is not ported")
        if cfg.test.use_pnp:
            raise NotImplementedError(
                "test.use_pnp: the RANSAC-Kabsch refinement is not ported")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.assets = assets
        self.batch_size = batch_size
        model = RDPN(cfg)
        if params_pkl:
            with open(params_pkl, "rb") as f:
                loaded = pickle.load(f)
            model.load_state_dict(state_dict_from_flax(
                cfg, loaded.get("params", {}), loaded.get("batch_stats", {})))
        elif allow_random_init:
            init_weights(model, torch.Generator().manual_seed(0))
        else:
            raise ValueError(
                "Predictor requires params_pkl (refusing to serve "
                "random-init weights); pass allow_random_init=True for "
                "smoke tests")
        self.model = model.to(device=self.device, dtype=dtype).eval()

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
            out = self.model(preprocess_rois_grouped(self.cfg, frames, rois))
            R = out["rot_ego"].cpu().numpy()
            t = out["trans"].cpu().numpy()
            for i, d in enumerate(dets):
                out_all.append({"obj_id": d.obj_id, "R": R[i], "t": t[i],
                                "score": d.score})
        return out_all
