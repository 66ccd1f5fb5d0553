"""ROI preprocessing, eval half: full frames + boxes -> network inputs.

Counterpart of ``rdpn6d_tpu/data/pipeline.py`` with ``train=False``:

    test-time DZI box -> bilinear RGB crop to input_res² -> pixel normalize
    -> bilinear depth crop -> depth / resize_ratio back-projected through
    the crop-composed intrinsics -> the 5-channel coord map at out_res²
    (depth xyz strided + the cropped 2-D coordinate map).

Batched over ROIs, each reading its frame by index, so frames are moved to
the device once whatever the number of detections. The crops are gathers
(``ops/warp.py``); the TPU path writes them as matmuls for the MXU. Depth
stays float32 end to end. The train half (jittered boxes, GT labels) is
not ported yet.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..geometry.camera import backproject_depth, crop_K
from ..ops.warp import crop_affine, crop_resize_frames


def dzi_jitter(bbox_xyxy: torch.Tensor, im_hw: tuple[int, int],
               pad_scale: float = 1.5, enable: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Test-time dynamic-zoom-in box: bbox [..., 4] -> (center [..., 2],
    scale [...] = max side * pad_scale, clipped to [1, max(H, W)])."""
    if enable:
        raise NotImplementedError("DZI jitter belongs to training, which "
                                  "is not ported yet")
    x1, y1, x2, y2 = bbox_xyxy.unbind(-1)
    center = torch.stack([0.5 * (x1 + x2), 0.5 * (y1 + y2)], dim=-1)
    scale = torch.maximum(y2 - y1, x2 - x1) * pad_scale
    return center, scale.clamp(1.0, float(max(im_hw)))


def coord_2d_map(height: int, width: int,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """Full-frame normalized 2-D coordinate map [H, W, 2] in [0, 1]."""
    x = torch.linspace(0.0, 1.0, width, device=device)
    y = torch.linspace(0.0, 1.0, height, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def _backproject_crop(depth_crop: torch.Tensor, K: torch.Tensor,
                      center: torch.Tensor, scale: torch.Tensor,
                      input_res: int, out_res: int) -> torch.Tensor:
    """depth crops [B, S, S] -> camera-frame XYZ [B, S, S, 3] via the
    crop-warped intrinsics, depth divided by resize_ratio first."""
    Kc = crop_K(K, crop_affine(center, scale, input_res))
    resize_ratio = out_res / scale
    return backproject_depth(depth_crop / resize_ratio[:, None, None], Kc)


def preprocess_rois_grouped(cfg: Config, frames: dict[str, torch.Tensor],
                            rois: dict[str, torch.Tensor],
                            train: bool = False) -> dict[str, torch.Tensor]:
    """Eval preprocessing of B ROIs cut from F frames (frame-deduplicated:
    many ROIs share few frames).

    frames: rgb [F,H,W,3] (0..255, uint8 welcome), depth [F,H,W] metres or
    depth_raw [F,H,W] + depth_factor [F], K [F,3,3].
    rois: frame_idx [B] plus bbox [B,4] (xyxy), fps [B,K,3], extent [B,3];
    roi_points / sym_rots / roi_cls pass through when present.
    """
    if train:
        raise NotImplementedError("train-mode preprocessing is not ported "
                                  "yet")
    d = cfg.data
    input_res, out_res = d.input_res, d.out_res
    rgb_full = frames["rgb"]
    H, W = rgb_full.shape[1], rgb_full.shape[2]
    dev = rgb_full.device
    if "depth_raw" in frames:
        depth_full = frames["depth_raw"].float() \
            / frames["depth_factor"].float()[:, None, None]
    else:
        depth_full = frames["depth"].float()
    fidx = rois["frame_idx"].long()
    bbox = rois["bbox"].float()
    K = frames["K"].float()[fidx]

    center, scale = dzi_jitter(bbox, (H, W), d.dzi_pad_scale)
    bw = (bbox[:, 2] - bbox[:, 0]).clamp_min(1.0)
    bh = (bbox[:, 3] - bbox[:, 1]).clamp_min(1.0)
    resize_ratio = out_res / scale

    rgb = crop_resize_frames(rgb_full, fidx, center, scale, input_res)
    mean = torch.tensor(d.pixel_mean, dtype=torch.float32, device=dev)
    std = torch.tensor(d.pixel_std, dtype=torch.float32, device=dev)
    rgb = (rgb - mean) / std

    depth_crop = crop_resize_frames(depth_full, fidx, center, scale,
                                    input_res)
    depth_xyz = _backproject_crop(depth_crop, K, center, scale, input_res,
                                  out_res)
    roi_img = torch.cat([rgb, depth_xyz], dim=-1)       # [B, S, S, 6]

    coord2d = crop_resize_frames(coord_2d_map(H, W, dev)[None],
                                 torch.zeros_like(fidx), center, scale,
                                 out_res)
    stride = input_res // out_res
    roi_coord_2d = torch.cat([depth_xyz[:, ::stride, ::stride], coord2d],
                             dim=-1)                    # [B, O, O, 5]
    out = {
        "roi_img": roi_img,
        "roi_coord_2d": roi_coord_2d,
        "roi_cam": K,
        "bbox_center": center,
        "scale": scale,
        "roi_wh": torch.stack([bw, bh], dim=-1),
        "resize_ratio": resize_ratio,
        "fps": rois["fps"].float(),
        "roi_extent": rois["extent"].float(),
    }
    for k in ("roi_points", "sym_rots", "roi_cls"):
        if k in rois:
            out[k] = rois[k]
    return out


def preprocess_roi(cfg: Config, sample: dict[str, torch.Tensor],
                   train: bool = False) -> dict[str, torch.Tensor]:
    """One ROI: sample holds the full frame (rgb [H,W,3], depth [H,W] or
    depth_raw + depth_factor, K [3,3]) and bbox [4], fps [K,3],
    extent [3]. Returns the unbatched network inputs."""
    frame_keys = ("rgb", "depth", "depth_raw", "depth_factor", "K")
    frames = {k: torch.as_tensor(sample[k])[None] for k in frame_keys
              if k in sample}
    rois = {k: torch.as_tensor(v)[None] for k, v in sample.items()
            if k not in frame_keys}
    rois["frame_idx"] = torch.zeros(1, dtype=torch.long,
                                    device=frames["rgb"].device)
    out = preprocess_rois_grouped(cfg, frames, rois, train)
    return {k: v[0] for k, v in out.items()}
