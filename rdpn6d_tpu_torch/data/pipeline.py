"""ROI preprocessing: full frames + boxes -> network inputs, and in train
mode the GT labels.

Counterpart of ``rdpn6d_tpu/data/pipeline.py``:

    DZI box (jittered in train mode) -> bilinear RGB crop to input_res²
    -> in train mode, colour augmentation of the ROIs whose
    Bernoulli(``data.color_aug_prob``) came up (``data/augment.py``)
    -> pixel normalize -> bilinear depth crop -> depth / resize_ratio
    back-projected through the crop-composed intrinsics -> the 5-channel
    coord map at out_res² (depth xyz strided + the cropped 2-D coordinate
    map); in train mode also the nearest crop of the GT masks and xyz map
    -> region ids + rotated FPS residuals (``ops/gt_labels.gt_labels``,
    one CUDA kernel on the card; without a GT xyz map, the nearest crop
    of the frame's depth and the masks, back-projected and rotated into
    the model frame, ``ops/surface_labels.surface_labels``, one kernel
    too) -> pose targets (trans_ratio, allocentric rot6d) and, for
    CE_coor, coordinate bins.

Batched over ROIs, each reading its frame by index, so frames are moved to
the device once whatever the number of ROIs; per-instance GT maps ride the
ROI axis. ``preprocess_batch`` is the flat path's form (each ROI with a
full frame of its own, the JAX package's ``preprocess_batch``): the same
batch with ``frame_idx = arange(B)``. The network inputs (the RGB and
depth crops, the normalisation, the back-projection and the coordinate
map) come from one kernel on the card (``ops/roi_crop.roi_crop``),
gathers on the CPU (``ops/warp.py``); the TPU path writes the crops as
matmuls for the MXU. Depth stays float32 end to end.

The DZI and colour-aug draws cannot match JAX's threefry, so they are
inputs: pass ``center_scale`` to use given boxes and ``aug_params`` given
colour-aug draws, or a ``torch.Generator`` (on the tensors' device) for
whichever is not given (the DZI draws first).
"""

from __future__ import annotations

import torch

from ..config import Config
from ..geometry.allocentric import ego_to_allo_mat
from ..geometry.rotations import mat_to_ortho6d
from ..ops.binning import quantize_coords
from ..ops.gt_labels import gt_labels
from ..ops.roi_crop import roi_crop
from ..ops.surface_labels import surface_labels
from ..utils.profiling import span
from .augment import color_augment, config_ops, draw_color_aug


def dzi_jitter(bbox_xyxy: torch.Tensor, im_hw: tuple[int, int],
               dzi_type: str = "uniform", pad_scale: float = 1.5,
               scale_ratio: float = 0.25, shift_ratio: float = 0.25,
               enable: bool = False,
               generator: torch.Generator | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic-zoom-in box: bbox [B, 4] (xyxy) -> (center [B, 2],
    scale [B] clipped to [1, max(H, W)]).

    ``enable=False`` gives the test-time box (center, max side *
    pad_scale). Enabled, ``uniform`` scales the side by 1 + scale_ratio*r
    and shifts the center by shift_ratio*(w, h)*r, r ~ U(-1, 1);
    ``roi10d`` moves each corner by up to 15% of the box side and clips
    it to the frame. Draws come from ``generator``."""
    x1, y1, x2, y2 = bbox_xyxy.unbind(-1)
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    bw, bh = x2 - x1, y2 - y1
    side = torch.maximum(bh, bw)
    B = bbox_xyxy.shape[0]

    def draw(n, lo, hi):
        r = torch.rand((B, n), generator=generator, dtype=torch.float32,
                       device=bbox_xyxy.device)
        return lo + (hi - lo) * r

    if enable and dzi_type == "uniform":
        r = draw(3, -1.0, 1.0)
        center = torch.stack([cx + bw * shift_ratio * r[:, 1],
                              cy + bh * shift_ratio * r[:, 2]], dim=-1)
        scale = side * (1.0 + scale_ratio * r[:, 0]) * pad_scale
    elif enable and dzi_type == "roi10d":
        r = draw(4, -0.15, 0.15)
        nx1 = (x1 + bw * r[:, 0]).clamp(0.0, float(im_hw[1]))
        nx2 = (x2 + bw * r[:, 1]).clamp(0.0, float(im_hw[1]))
        ny1 = (y1 + bh * r[:, 2]).clamp(0.0, float(im_hw[0]))
        ny2 = (y2 + bh * r[:, 3]).clamp(0.0, float(im_hw[0]))
        center = torch.stack([0.5 * (nx1 + nx2), 0.5 * (ny1 + ny2)], dim=-1)
        scale = torch.maximum(ny2 - ny1, nx2 - nx1) * pad_scale
    elif enable and dzi_type not in ("none", ""):
        raise NotImplementedError(f"DZI type {dzi_type!r} not implemented "
                                  "(use uniform | roi10d | none)")
    else:
        center = torch.stack([cx, cy], dim=-1)
        scale = side * pad_scale
    return center, scale.clamp(1.0, float(max(im_hw)))


_GT_FRAME_KEYS = ("xyz", "mask_visib", "mask_trunc")


def preprocess_rois_grouped(
        cfg: Config, frames: dict[str, torch.Tensor],
        rois: dict[str, torch.Tensor], train: bool = False,
        generator: torch.Generator | None = None,
        center_scale: tuple[torch.Tensor, torch.Tensor] | None = None,
        aug_params: dict | None = None,
) -> dict[str, torch.Tensor]:
    """Preprocessing of B ROIs cut from F frames (frame-deduplicated:
    many ROIs share few frames).

    frames: rgb [F,H,W,3] (0..255, uint8 welcome), depth [F,H,W] metres or
    depth_raw [F,H,W] + depth_factor [F], K [F,3,3].
    rois: frame_idx [B] plus bbox [B,4] (xyxy), fps [B,K,3], extent [B,3];
    roi_points / sym_rots / roi_cls pass through when present. In train
    mode also gt_rot [B,3,3], gt_trans [B,3], centroid_2d [B,2], and the
    per-ROI GT maps: mask_packed [B,h,w] uint8 (visib bit 0, trunc bit 1)
    or mask_visib [B,h,w] (+ mask_trunc), and optionally xyz [B,h,w,3]
    (float16 welcome) with xyz_offset [B,2] when the maps are crops whose
    top-left sits at that frame pixel. Without xyz, model-frame coords
    come from the depth surface. ``center_scale`` replaces the DZI box;
    ``aug_params`` replaces the colour-aug draws in train mode when
    ``data.color_aug_prob > 0``: ``{"apply": [B] bool (the per-ROI
    Bernoulli), "ops": augment.draw_aug_params(...)}``, as
    ``augment.draw_color_aug`` draws them; ``generator`` drives the draws
    not given.

    Traced (``utils.profiling.span``) as ``rdpn.pre``, with
    ``rdpn.pre.crop``, ``rdpn.pre.color_aug`` and ``rdpn.pre.labels``
    inside it.
    """
    with span("pre"):
        d = cfg.data
        if train and any(k in frames for k in _GT_FRAME_KEYS):
            # per-instance GT cannot live on the shared frame axis: two ROIs
            # of different objects in one frame would share one's targets
            raise ValueError(
                "preprocess_rois_grouped(train=True) with per-instance GT "
                "maps on the frame axis; pass GT maps per ROI instead")
        input_res, out_res = d.input_res, d.out_res
        rgb_full = frames["rgb"]
        if rgb_full.dtype not in (torch.uint8, torch.float32):
            rgb_full = rgb_full.float()
        H, W = rgb_full.shape[1], rgb_full.shape[2]
        dev = rgb_full.device
        if "depth_raw" in frames:
            depth, factor = frames["depth_raw"], frames["depth_factor"].float()
            if depth.dtype == torch.uint16:     # as the JAX package ships it
                depth = depth.to(torch.int32)
        else:
            depth, factor = frames["depth"].float(), None
        fidx = rois["frame_idx"].long()
        bbox = rois["bbox"].float()
        K_frames = frames["K"].float()
        K = K_frames[fidx]

        if center_scale is not None:
            center, scale = (t.float() for t in center_scale)
        else:
            center, scale = dzi_jitter(
                bbox, (H, W), d.dzi_type, d.dzi_pad_scale, d.dzi_scale_ratio,
                d.dzi_shift_ratio, enable=train, generator=generator)
        bw = (bbox[:, 2] - bbox[:, 0]).clamp_min(1.0)
        bh = (bbox[:, 3] - bbox[:, 1]).clamp_min(1.0)
        resize_ratio = out_res / scale

        ops = config_ops(d.color_aug_ops, d.color_aug_type) \
            if train and d.color_aug_prob > 0 else ()
        # [B, S, S, 6] and [B, O, O, 5]: one kernel on the card
        with span("pre.crop"):
            roi_img, roi_coord_2d = roi_crop(
                rgb_full, depth, factor, K_frames, fidx, center, scale,
                input_res, out_res, d.pixel_mean, d.pixel_std,
                normalize=not ops)
        if ops:
            # colour aug between the crop and the normalisation, on the RGB
            with span("pre.color_aug"):
                rgb = roi_img[..., :3]
                if aug_params is None:
                    aug_params = draw_color_aug(ops, fidx.shape[0],
                                                d.color_aug_prob, generator,
                                                (input_res, input_res), dev)
                aug = color_augment(rgb, aug_params["ops"], ops)
                rgb = torch.where(
                    aug_params["apply"].to(dev)[:, None, None, None], aug, rgb)
                mean = torch.tensor(d.pixel_mean, dtype=torch.float32,
                                    device=dev)
                std = torch.tensor(d.pixel_std, dtype=torch.float32,
                                   device=dev)
                roi_img[..., :3] = (rgb - mean) / std
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
        if not train:
            return out
        with span("pre.labels"):
            out.update(_train_labels(cfg, rois, depth, factor, fidx, K, center,
                                     scale, bw, bh, resize_ratio))
        return out


def _train_labels(cfg: Config, rois: dict[str, torch.Tensor],
                  depth: torch.Tensor, factor: torch.Tensor | None,
                  fidx: torch.Tensor,
                  K: torch.Tensor, center: torch.Tensor, scale: torch.Tensor,
                  bw: torch.Tensor, bh: torch.Tensor,
                  resize_ratio: torch.Tensor) -> dict[str, torch.Tensor]:
    """GT masks, region ids, coordinate targets and pose targets."""
    out_res = cfg.data.out_res
    packed = rois.get("mask_packed")
    if packed is not None:
        visib_in, trunc_in = packed, None   # bits read where they are cropped
    else:
        visib_in = rois["mask_visib"].float()
        trunc_in = rois["mask_trunc"].float() if "mask_trunc" in rois \
            else None
    fps, extent = rois["fps"].float(), rois["extent"].float()
    R_gt, t_gt = rois["gt_rot"].float(), rois["gt_trans"].float()
    residual = cfg.head.coord_residual

    # the nearest crop of the masks and the model-frame coords, and the
    # labels: one kernel on the card either way
    if "xyz" in rois:
        xyz = rois["xyz"]
        if xyz.dtype != torch.float16:
            xyz = xyz.float()
        # crop-shipped GT: the maps' top-left sits at xyz_offset
        gt_center = center if "xyz_offset" not in rois \
            else center - rois["xyz_offset"].float()
        labels = gt_labels(visib_in, trunc_in, xyz, gt_center, scale, fps,
                           R_gt, extent, out_res, residual=residual)
    else:
        # no xyz map: xyz = R^T (p_cam - t) of each tap's back-projection,
        # from the full-frame depth in metres
        depth_full = depth if factor is None \
            else depth.float() / factor[:, None, None]
        labels = surface_labels(depth_full, fidx, visib_in, trunc_in, K,
                                center, scale, fps, R_gt, t_gt, extent,
                                out_res, residual=residual)
    roi_mask_visib = labels["roi_mask_visib"]
    roi_mask_obj = labels["roi_mask_obj"]
    roi_mask_trunc = labels["roi_mask_trunc"]
    region, coord = labels["roi_region"], labels["roi_xyz"]

    delta_c = rois["centroid_2d"].float() - center
    trans_ratio = torch.stack([delta_c[:, 0] / bw, delta_c[:, 1] / bh,
                               t_gt[:, 2] / resize_ratio], dim=-1)
    out = {
        "roi_mask_trunc": roi_mask_trunc,
        "roi_mask_visib": roi_mask_visib,
        "roi_mask_obj": roi_mask_obj,
        "roi_xyz": coord,
        "roi_region": region,
        "gt_rot": R_gt,
        "gt_trans": t_gt,
        "trans_ratio": trans_ratio,
        "gt_allo_rot6d": mat_to_ortho6d(ego_to_allo_mat(t_gt, R_gt)),
    }
    if cfg.head.xyz_loss == "CE_coor":
        masks = {"trunc": roi_mask_trunc, "visib": roi_mask_visib,
                 "obj": roi_mask_obj}
        out["roi_xyz_bin"] = quantize_coords(
            coord, masks[cfg.head.xyz_loss_mask], cfg.head.xyz_bin)
    return out


_FLAT_FRAME_KEYS = ("rgb", "depth", "depth_raw", "depth_factor", "K")


def preprocess_batch(
        cfg: Config, samples: dict[str, torch.Tensor], train: bool = True,
        generator: torch.Generator | None = None,
        center_scale: tuple[torch.Tensor, torch.Tensor] | None = None,
        aug_params: dict | None = None,
) -> dict[str, torch.Tensor]:
    """The flat path's preprocessing of B ROIs, each with its own frame:
    ``samples`` as ``loader.train_frame_iterator`` stacks them (rgb
    [B,H,W,3], depth [B,H,W] metres, K [B,3,3], and per ROI the box, the
    pose, the assets and in train mode float32 ``xyz`` [B,H,W,3],
    ``mask_visib`` and ``mask_trunc`` [B,H,W]). The frames are ROI ``i``'s
    own (``frame_idx = arange(B)``), so one crop is one ``roi_crop``
    launch and the labels one ``gt_labels`` launch, fed the float32 planes
    as they come. The other arguments as ``preprocess_rois_grouped``."""
    frames = {k: v for k, v in samples.items() if k in _FLAT_FRAME_KEYS}
    rois = {k: v for k, v in samples.items() if k not in _FLAT_FRAME_KEYS}
    rois["frame_idx"] = torch.arange(frames["rgb"].shape[0],
                                     device=frames["rgb"].device)
    return preprocess_rois_grouped(cfg, frames, rois, train, generator,
                                   center_scale, aug_params)


def preprocess_roi(cfg: Config, sample: dict[str, torch.Tensor],
                   train: bool = False,
                   generator: torch.Generator | None = None,
                   center_scale: tuple[torch.Tensor, torch.Tensor]
                   | None = None) -> dict[str, torch.Tensor]:
    """One ROI: sample holds the full frame (rgb [H,W,3], depth [H,W] or
    depth_raw + depth_factor, K [3,3]) and bbox [4], fps [K,3], extent [3]
    (+ the train keys of ``preprocess_rois_grouped``, unbatched).
    ``center_scale`` is (center [2], scale []). Returns the unbatched
    network inputs (and labels)."""
    frame_keys = ("rgb", "depth", "depth_raw", "depth_factor", "K")
    frames = {k: torch.as_tensor(sample[k])[None] for k in frame_keys
              if k in sample}
    rois = {k: torch.as_tensor(v)[None] for k, v in sample.items()
            if k not in frame_keys}
    rois["frame_idx"] = torch.zeros(1, dtype=torch.long,
                                    device=frames["rgb"].device)
    if center_scale is not None:
        center_scale = tuple(torch.as_tensor(t).reshape(shape) for t, shape
                             in zip(center_scale, ((1, 2), (1,))))
    out = preprocess_rois_grouped(cfg, frames, rois, train, generator,
                                  center_scale)
    return {k: v[0] for k, v in out.items()}
