"""The xyz-shipped train labels of B ROIs in one pass: the nearest crop of
each ROI's GT maps to out x out, then masks, region ids and coordinate
targets.

Counterpart of the xyz branch of ``rdpn6d_tpu/data/pipeline.py``'s train
labels (the stacked nearest ``crop_resize_mm`` of the mask and xyz planes,
then ``ops/region.residual_coord_target``, or ``xyz_to_region`` and
xyz / extent + 0.5 in GDR-Net's absolute mode).

``gt_labels`` picks by the tensors' device: CPU tensors take the plain
version, CUDA tensors launch the ``gt_labels`` entry point of
``csrc/region_label.cu`` (built with nvcc at first use) or raise. The plain
version stacks float32 planes of the full-size maps and gathers them; the
kernel reads the maps in their shipped types at the sampled taps only. Both
round the taps alike, so the masks agree bit for bit; region ids follow
``ops/region``'s direct distance form.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .region import region_label_plain
from .warp import crop_resize_frames

LIBRARY = "region_label"       # csrc/region_label.cu holds the entry point
KERNEL = "gt_labels"           # the name its launches are counted under

Labels = dict[str, torch.Tensor]


def gt_labels_plain(mask: torch.Tensor, trunc: torch.Tensor | None,
                    xyz: torch.Tensor, center: torch.Tensor,
                    scale: torch.Tensor, fps: torch.Tensor,
                    rot: torch.Tensor, extent: torch.Tensor, out_res: int,
                    residual: bool = True) -> Labels:
    """The plain PyTorch version (arguments as ``gt_labels``): one stacked
    float32 nearest crop of the masks and the xyz map, then the labels."""
    if mask.dtype == torch.uint8:
        visib_in = (mask & 1).float()
        trunc_in = ((mask >> 1) & 1).float()
    else:
        visib_in, trunc_in = mask, trunc
    xyz_full = xyz.float()
    mask_obj = (xyz_full != 0).any(dim=-1).float()
    planes = [(visib_in * mask_obj)[..., None], mask_obj[..., None], xyz_full]
    if trunc_in is not None:
        planes.append((trunc_in * mask_obj)[..., None])
    own = torch.arange(xyz.shape[0], device=xyz.device)
    stacked = crop_resize_frames(torch.cat(planes, dim=-1), own, center,
                                 scale, out_res, interp="nearest")
    roi_xyz = stacked[..., 2:5].contiguous()
    region, coord = region_label_plain(roi_xyz, fps, rot, extent)
    if not residual:
        coord = roi_xyz / extent[:, None, None, :] + 0.5
    visib = stacked[..., 0]
    return {"roi_mask_visib": visib, "roi_mask_obj": stacked[..., 1],
            "roi_mask_trunc": stacked[..., 5] if trunc_in is not None
            else visib, "roi_region": region, "roi_xyz": coord}


def _check(mask, trunc, xyz, center, scale, fps, rot, extent,
           out_res) -> None:
    ts = [t for t in (mask, trunc, xyz, center, scale, fps, rot, extent)
          if t is not None]
    if any(t.device != xyz.device for t in ts):
        raise ValueError("gt_labels: inputs on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if xyz.dtype not in (torch.float16, torch.float32):
        raise TypeError(f"gt_labels: xyz must be float16 or float32, got "
                        f"{xyz.dtype}")
    if mask.dtype == torch.uint8:
        if trunc is not None:
            raise ValueError("gt_labels: packed masks carry trunc in bit 1;"
                             " no separate trunc plane")
    elif mask.dtype != torch.float32 or (trunc is not None
                                         and trunc.dtype != torch.float32):
        raise TypeError("gt_labels: masks must be packed uint8 or float32, "
                        f"got {mask.dtype}"
                        + ("" if trunc is None else f" and {trunc.dtype}"))
    floats = (center, scale, fps, rot, extent)
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("gt_labels: float32 center, scale, fps, rot and "
                        f"extent required, got {[t.dtype for t in floats]}")
    B = xyz.shape[0]
    if xyz.dim() != 4 or xyz.shape[3] != 3 \
            or mask.shape != xyz.shape[:3] \
            or (trunc is not None and trunc.shape != mask.shape) \
            or center.shape != (B, 2) or scale.shape != (B,) \
            or fps.dim() != 3 or fps.shape[0] != B or fps.shape[2] != 3 \
            or rot.shape != (B, 3, 3) or extent.shape != (B, 3):
        raise ValueError(
            "gt_labels: expected mask [B,h,w] (+ trunc [B,h,w]), xyz "
            "[B,h,w,3], center [B,2], scale [B], fps [B,K,3], rot [B,3,3], "
            f"extent [B,3]; got {[tuple(t.shape) for t in ts]}")
    if fps.shape[1] == 0:
        raise ValueError("gt_labels: no keypoints")
    if xyz.shape[1] == 0 or xyz.shape[2] == 0 or out_res <= 0:
        raise ValueError(f"gt_labels: empty map {tuple(xyz.shape[1:3])} or "
                         f"out_res {out_res}")


def gt_labels_cuda(mask: torch.Tensor, trunc: torch.Tensor | None,
                   xyz: torch.Tensor, center: torch.Tensor,
                   scale: torch.Tensor, fps: torch.Tensor, rot: torch.Tensor,
                   extent: torch.Tensor, out_res: int,
                   residual: bool = True) -> Labels:
    """Launch the kernel on the current stream (arguments as
    ``gt_labels``; CUDA tensors, any K >= 1)."""
    _check(mask, trunc, xyz, center, scale, fps, rot, extent, out_res)
    if xyz.device.type != "cuda":
        raise ValueError(f"gt_labels_cuda: CUDA tensors required, got "
                         f"{xyz.device}")
    lib, _ = cuda_build.load(LIBRARY)
    B, h, w, _ = xyz.shape
    K = fps.shape[1]
    if B > 65535:
        raise ValueError(f"gt_labels: B={B} exceeds the grid's y limit")
    packed = mask.dtype == torch.uint8
    mask, xyz, center, scale, fps, rot, extent = (
        t.contiguous() for t in (mask, xyz, center, scale, fps, rot, extent))
    trunc = trunc.contiguous() if trunc is not None else None
    dev, o = xyz.device, out_res
    visib = torch.empty((B, o, o), dtype=torch.float32, device=dev)
    obj = torch.empty_like(visib)
    trunc_out = torch.empty_like(visib) if packed or trunc is not None \
        else None
    region = torch.empty((B, o, o), dtype=torch.int32, device=dev)
    coord = torch.empty((B, o, o, 3), dtype=torch.float32, device=dev)
    labels = {"roi_mask_visib": visib, "roi_mask_obj": obj,
              "roi_mask_trunc": trunc_out if trunc_out is not None
              else visib, "roi_region": region, "roi_xyz": coord}
    if B == 0:
        return labels

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = lib.gt_labels_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(mask), ptr(trunc), int(packed), ptr(xyz),
                 int(xyz.dtype == torch.float16), ptr(center), ptr(scale),
                 ptr(fps), ptr(rot), ptr(extent), ptr(visib), ptr(obj),
                 ptr(trunc_out), ptr(region), ptr(coord), B, h, w, o, K,
                 int(residual), stream)
    if err != 0:
        lib.region_label_error_string.restype = ctypes.c_char_p
        lib.region_label_error_string.argtypes = [ctypes.c_int]
        msg = lib.region_label_error_string(err).decode()
        raise RuntimeError(f"gt_labels kernel launch failed: {msg} ({err})")
    cuda_build.count_launch(KERNEL)
    return labels


def gt_labels(mask: torch.Tensor, trunc: torch.Tensor | None,
              xyz: torch.Tensor, center: torch.Tensor, scale: torch.Tensor,
              fps: torch.Tensor, rot: torch.Tensor, extent: torch.Tensor,
              out_res: int, residual: bool = True) -> Labels:
    """Masks, region ids and coordinate targets of B ROIs at out_res².

    mask: packed uint8 [B,h,w] (visib bit 0, trunc bit 1; ``trunc`` None)
    or float32 visib [B,h,w] with ``trunc`` a float32 [B,h,w] or None;
    xyz [B,h,w,3] float16 or float32 object-frame coordinates (0 at the
    background); center [B,2] (x, y) of each crop in its maps' pixels and
    scale [B] its side (``ops/warp`` conventions, nearest taps rounded half
    to even, out-of-map taps 0); fps [B,K,3], rot [B,3,3], extent [B,3]
    float32. Returns float32 ``roi_mask_visib``, ``roi_mask_obj``,
    ``roi_mask_trunc`` (visib itself without a trunc plane), each masked
    by the object, [B,o,o]; ``roi_region`` int32 [B,o,o] in 0..K;
    ``roi_xyz`` [B,o,o,3], R (xyz - fps[nearest]) / extent + 0.5 when
    ``residual``, else xyz / extent + 0.5. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    _check(mask, trunc, xyz, center, scale, fps, rot, extent, out_res)
    if xyz.device.type == "cpu":
        return gt_labels_plain(mask, trunc, xyz, center, scale, fps, rot,
                               extent, out_res, residual)
    if xyz.device.type == "cuda":
        return gt_labels_cuda(mask, trunc, xyz, center, scale, fps, rot,
                              extent, out_res, residual)
    raise ValueError(f"gt_labels: no kernel for device {xyz.device}")
