"""The train labels of B ROIs from the depth surface, for splits that ship
no GT xyz map (BOP-PBR): the nearest crop of each ROI's frame depth and
masks to out x out, the back-projection of every tap, its model-frame
coordinates R^T (p - t), then masks, region ids and coordinate targets.

Counterpart of the depth-surface branch of ``rdpn6d_tpu/data/pipeline.py``'s
train labels (the stacked nearest ``crop_resize_mm`` of [visib, depth, u,
v(, trunc)], the back-projection with the frame's K, the rotation, then
``ops/region.residual_coord_target``, or ``xyz_to_region`` and
xyz / extent + 0.5 in GDR-Net's absolute mode).

``surface_labels`` picks by the tensors' device: CPU tensors take the
plain version, CUDA tensors launch the ``surface_labels`` entry point of
``csrc/region_label.cu`` (built with nvcc at first use) or raise. The
plain version widens the full-frame masks to float32 planes, gathers them,
the depth and a (u, v) grid, and forms the coordinates as sums in a fixed
order; the kernel reads the frames at the sampled taps only and rounds
every op as the plain version does, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .region import _foreground, _gather_fps, _nearest_plain
from .warp import crop_resize_frames

LIBRARY = "region_label"       # csrc/region_label.cu holds the entry point
KERNEL = "surface_labels"      # the name its launches are counted under

Labels = dict[str, torch.Tensor]


def surface_labels_plain(depth: torch.Tensor, frame_idx: torch.Tensor,
                         mask: torch.Tensor, trunc: torch.Tensor | None,
                         cam: torch.Tensor, center: torch.Tensor,
                         scale: torch.Tensor, fps: torch.Tensor,
                         rot: torch.Tensor, trans: torch.Tensor,
                         extent: torch.Tensor, out_res: int,
                         residual: bool = True) -> Labels:
    """The plain PyTorch version (arguments as ``surface_labels``): nearest
    crops of the (u, v) grid, the depth and the stacked float32 masks,
    then the back-projection and the labels."""
    if mask.dtype == torch.uint8:
        visib_in = (mask & 1).float()
        trunc_in = ((mask >> 1) & 1).float()
    else:
        visib_in, trunc_in = mask, trunc
    H, W = depth.shape[1], depth.shape[2]
    dev = depth.device

    def nearest(planes, idx):
        return crop_resize_frames(planes, idx, center, scale, out_res,
                                  interp="nearest")

    # the nearest crop picks one source pixel (u, v) per output pixel
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    uv = nearest(torch.stack([u, v], dim=-1)[None],
                 torch.zeros_like(frame_idx))
    depth_c = nearest(depth, frame_idx)
    masks = [visib_in] + ([trunc_in] if trunc_in is not None else [])
    mask_c = nearest(torch.stack(masks, dim=-1),
                     torch.arange(mask.shape[0], device=dev))
    m = (depth_c > 1e-6).float() * mask_c[..., 0]
    fx, fy = cam[:, 0, 0, None, None], cam[:, 1, 1, None, None]
    px, py = cam[:, 0, 2, None, None], cam[:, 1, 2, None, None]
    a = torch.stack([(uv[..., 0] - px) * depth_c / fx,
                     (uv[..., 1] - py) * depth_c / fy, depth_c], dim=-1) \
        - trans[:, None, None, :]
    r = rot[:, None, None]                          # [B,1,1,3,3]
    # xyz = R^T (p - t), the sums in the kernel's order
    xyz = ((a[..., 0:1] * r[..., 0, :] + a[..., 1:2] * r[..., 1, :])
           + a[..., 2:3] * r[..., 2, :]) * m[..., None]
    nearest_k = _nearest_plain(xyz, fps)
    region = torch.where(_foreground(xyz), nearest_k.to(torch.int32) + 1,
                         torch.zeros((), dtype=torch.int32, device=dev))
    if residual:
        delta = xyz - _gather_fps(fps, nearest_k)
        coord = ((delta[..., 0:1] * r[..., :, 0]
                  + delta[..., 1:2] * r[..., :, 1])
                 + delta[..., 2:3] * r[..., :, 2])
    else:
        coord = xyz
    coord = coord / extent[:, None, None, :] + 0.5
    return {"roi_mask_visib": m, "roi_mask_obj": m,
            "roi_mask_trunc": mask_c[..., 1] * m if trunc_in is not None
            else m, "roi_region": region, "roi_xyz": coord}


def _check(depth, frame_idx, mask, trunc, cam, center, scale, fps, rot,
           trans, extent, out_res) -> None:
    ts = [t for t in (depth, frame_idx, mask, trunc, cam, center, scale,
                      fps, rot, trans, extent) if t is not None]
    if any(t.device != depth.device for t in ts):
        raise ValueError("surface_labels: inputs on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if mask.dtype == torch.uint8:
        if trunc is not None:
            raise ValueError("surface_labels: packed masks carry trunc in "
                             "bit 1; no separate trunc plane")
    elif mask.dtype != torch.float32 or (trunc is not None
                                         and trunc.dtype != torch.float32):
        raise TypeError("surface_labels: masks must be packed uint8 or "
                        f"float32, got {mask.dtype}"
                        + ("" if trunc is None else f" and {trunc.dtype}"))
    if frame_idx.dtype != torch.int64:
        raise TypeError(f"surface_labels: int64 frame_idx required, got "
                        f"{frame_idx.dtype}")
    floats = (depth, cam, center, scale, fps, rot, trans, extent)
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("surface_labels: float32 depth, cam, center, scale, "
                        "fps, rot, trans and extent required, got "
                        f"{[t.dtype for t in floats]}")
    B = mask.shape[0]
    if depth.dim() != 3 or mask.shape != (B, *depth.shape[1:]) \
            or (trunc is not None and trunc.shape != mask.shape) \
            or frame_idx.shape != (B,) or cam.shape != (B, 3, 3) \
            or center.shape != (B, 2) or scale.shape != (B,) \
            or fps.dim() != 3 or fps.shape[0] != B or fps.shape[2] != 3 \
            or rot.shape != (B, 3, 3) or trans.shape != (B, 3) \
            or extent.shape != (B, 3):
        raise ValueError(
            "surface_labels: expected depth [F,h,w], frame_idx [B], mask "
            "[B,h,w] (+ trunc [B,h,w]), cam [B,3,3], center [B,2], scale "
            "[B], fps [B,K,3], rot [B,3,3], trans [B,3], extent [B,3]; got "
            f"{[tuple(t.shape) for t in ts]}")
    if fps.shape[1] == 0:
        raise ValueError("surface_labels: no keypoints")
    if depth.shape[0] == 0 or depth.shape[1] == 0 or depth.shape[2] == 0 \
            or out_res <= 0:
        raise ValueError(f"surface_labels: empty frames "
                         f"{tuple(depth.shape)} or out_res {out_res}")


def surface_labels_cuda(depth: torch.Tensor, frame_idx: torch.Tensor,
                        mask: torch.Tensor, trunc: torch.Tensor | None,
                        cam: torch.Tensor, center: torch.Tensor,
                        scale: torch.Tensor, fps: torch.Tensor,
                        rot: torch.Tensor, trans: torch.Tensor,
                        extent: torch.Tensor, out_res: int,
                        residual: bool = True) -> Labels:
    """Launch the kernel on the current stream (arguments as
    ``surface_labels``; CUDA tensors, any K >= 1)."""
    _check(depth, frame_idx, mask, trunc, cam, center, scale, fps, rot,
           trans, extent, out_res)
    if depth.device.type != "cuda":
        raise ValueError(f"surface_labels_cuda: CUDA tensors required, got "
                         f"{depth.device}")
    lib, _ = cuda_build.load(LIBRARY)
    F, h, w = depth.shape
    B, K = mask.shape[0], fps.shape[1]
    if B > 65535:
        raise ValueError(f"surface_labels: B={B} exceeds the grid's y limit")
    packed = mask.dtype == torch.uint8
    depth, frame_idx, mask, cam, center, scale, fps, rot, trans, extent = (
        t.contiguous() for t in (depth, frame_idx, mask, cam, center, scale,
                                 fps, rot, trans, extent))
    trunc = trunc.contiguous() if trunc is not None else None
    dev, o = depth.device, out_res
    m = torch.empty((B, o, o), dtype=torch.float32, device=dev)
    trunc_out = torch.empty_like(m) if packed or trunc is not None else None
    region = torch.empty((B, o, o), dtype=torch.int32, device=dev)
    coord = torch.empty((B, o, o, 3), dtype=torch.float32, device=dev)
    labels = {"roi_mask_visib": m, "roi_mask_obj": m,
              "roi_mask_trunc": trunc_out if trunc_out is not None else m,
              "roi_region": region, "roi_xyz": coord}
    if B == 0:
        return labels

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = lib.surface_labels_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(depth), ptr(frame_idx), ptr(mask), ptr(trunc),
                 int(packed), ptr(cam), ptr(center), ptr(scale), ptr(fps),
                 ptr(rot), ptr(trans), ptr(extent), ptr(m), ptr(trunc_out),
                 ptr(region), ptr(coord), B, F, h, w, o, K, int(residual),
                 stream)
    if err != 0:
        lib.region_label_error_string.restype = ctypes.c_char_p
        lib.region_label_error_string.argtypes = [ctypes.c_int]
        msg = lib.region_label_error_string(err).decode()
        raise RuntimeError(f"surface_labels kernel launch failed: {msg} "
                           f"({err})")
    cuda_build.count_launch(KERNEL)
    return labels


def surface_labels(depth: torch.Tensor, frame_idx: torch.Tensor,
                   mask: torch.Tensor, trunc: torch.Tensor | None,
                   cam: torch.Tensor, center: torch.Tensor,
                   scale: torch.Tensor, fps: torch.Tensor, rot: torch.Tensor,
                   trans: torch.Tensor, extent: torch.Tensor, out_res: int,
                   residual: bool = True) -> Labels:
    """Masks, region ids and coordinate targets of B ROIs at out_res², from
    the depth surface.

    depth [F,h,w] float32 frames in metres; frame_idx [B] int64, each
    ROI's frame; mask: each ROI's full-frame masks, packed uint8 [B,h,w]
    (visib bit 0, trunc bit 1; ``trunc`` None) or float32 visib [B,h,w]
    with ``trunc`` a float32 [B,h,w] or None; cam [B,3,3] each ROI's K;
    center [B,2] (x, y) and scale [B] its crop (``ops/warp`` conventions,
    nearest taps rounded half to even, off-frame taps 0); fps [B,K,3],
    rot [B,3,3] and trans [B,3] the GT pose, extent [B,3], float32.
    Returns float32 ``roi_mask_visib`` and ``roi_mask_obj``, one tensor
    m = (depth > 1e-6) * visib, and ``roi_mask_trunc`` = trunc * m (m
    itself without a trunc plane), [B,o,o]; ``roi_region`` int32 [B,o,o]
    in 0..K; ``roi_xyz`` [B,o,o,3], R (xyz - fps[nearest]) / extent + 0.5
    when ``residual``, else xyz / extent + 0.5, where xyz = R^T (p - t) m
    is the tap's back-projection p in the model frame. CPU tensors take
    the plain version, CUDA tensors the kernel."""
    _check(depth, frame_idx, mask, trunc, cam, center, scale, fps, rot,
           trans, extent, out_res)
    if depth.device.type == "cpu":
        return surface_labels_plain(depth, frame_idx, mask, trunc, cam,
                                    center, scale, fps, rot, trans, extent,
                                    out_res, residual)
    if depth.device.type == "cuda":
        return surface_labels_cuda(depth, frame_idx, mask, trunc, cam,
                                   center, scale, fps, rot, trans, extent,
                                   out_res, residual)
    raise ValueError(f"surface_labels: no kernel for device {depth.device}")
