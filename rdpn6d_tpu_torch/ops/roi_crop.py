"""The network inputs of B ROIs cut from F RGB-D frames in one pass: the
bilinear RGB crop (normalised), the bilinear depth crop back-projected
through the crop-composed intrinsics, and the 5-channel coordinate map.

Counterpart of the eval half of ``rdpn6d_tpu/data/pipeline.py``'s
``preprocess_roi`` (the RGB and depth ``crop_resize_mm``, the
normalisation, ``_backproject_crop``, the crop of ``coord_2d_map`` and the
two concatenations), which every served batch, eval batch and train step
runs.

``roi_crop`` picks by the tensors' device: CPU tensors take the plain
version, CUDA tensors launch the kernel of ``csrc/roi_crop.cu`` (built
with nvcc at first use) or raise. The plain version gathers the four
bilinear taps of the whole frames (``ops/warp.crop_resize_frames``) three
times; the kernel reads each tap once, rounds every op as the plain
version does and takes each division by a per-ROI constant as the
correctly rounded quotient from the divisor's reciprocal, so the two agree
bit for bit.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from ..geometry.camera import backproject_depth
from . import cuda_build
from .warp import crop_resize_frames

LIBRARY = "roi_crop"           # csrc/roi_crop.cu
KERNEL = "roi_crop"            # the name its launches are counted under
THREADS = 256                  # the kernel's threads a block (kThreads)
MAX_ROWS = 256                 # S-grid rows a block at most (kMaxRows)
BLOCKS_PER_SM = 3              # resident blocks an SM (__launch_bounds__)

_AXES: dict[tuple[int, int, str], tuple[torch.Tensor, torch.Tensor]] = {}


def coord_axes(height: int, width: int, device: torch.device | str
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The axes of the full-frame [0, 1] coordinate map, (x [W], y [H]),
    as ``torch.linspace`` computes them on ``device`` (from both ends: not
    i / (n - 1)); built once per (height, width, device)."""
    key = (height, width, str(torch.device(device)))
    if key not in _AXES:
        _AXES[key] = (torch.linspace(0.0, 1.0, width, device=device),
                      torch.linspace(0.0, 1.0, height, device=device))
    return _AXES[key]


def crop_intrinsics(K: torch.Tensor, center: torch.Tensor,
                    scale: torch.Tensor, input_res: int) -> torch.Tensor:
    """K [B,3,3] composed with the crop's affine: rows 0 and 1 are
    r K[i] + t_i K[2], r = input_res / scale, t_i = input_res / 2 - r c_i,
    and row 2 is K[2]; ``geometry.camera.crop_K`` of ``ops/warp.crop_affine``
    without its exact zero terms, element-wise (no matrix product, whose
    order of sums differs between devices)."""
    r = input_res / scale
    t = input_res / 2.0 - r[:, None] * center
    top = r[:, None, None] * K[:, :2] + t[:, :, None] * K[:, 2:3]
    return torch.cat([top, K[:, 2:3]], dim=1)


def roi_crop_plan(B: int, S: int, sms: int) -> tuple[int, int]:
    """The kernel's launch for B ROIs at input_res S on ``sms`` SMs: the
    iterations a block walks and the blocks of the grid. A block of
    ``THREADS`` threads computes R = THREADS // S whole rows an iteration
    where S <= THREADS, and walks enough iterations that the grid is about
    one wave of ``BLOCKS_PER_SM`` blocks an SM (at most ``MAX_ROWS`` rows
    and one ROI a block), so that the per-block set-up is paid a few
    hundred times, not once a tile; where S > THREADS a block is one
    THREADS-wide segment of a row."""
    if S > THREADS:
        return 1, B * S * -(-S // THREADS)
    R = THREADS // S
    tiles = -(-S // R)                         # iterations a ROI needs
    iters = max(1, min(MAX_ROWS // R, tiles,
                       -(-B * tiles // (sms * BLOCKS_PER_SM))))
    return iters, B * -(-tiles // iters)


def roi_crop_plain(rgb: torch.Tensor, depth: torch.Tensor,
                   depth_factor: torch.Tensor | None, K: torch.Tensor,
                   frame_idx: torch.Tensor, center: torch.Tensor,
                   scale: torch.Tensor, input_res: int, out_res: int,
                   mean: Sequence[float], std: Sequence[float],
                   normalize: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version (arguments as ``roi_crop``): the gather
    crops of the RGB, the depth and the coordinate map."""
    dev = rgb.device
    H, W = rgb.shape[1], rgb.shape[2]
    img = crop_resize_frames(rgb, frame_idx, center, scale, input_res)
    if normalize:
        img = (img - torch.tensor(mean, dtype=torch.float32, device=dev)) \
            / torch.tensor(std, dtype=torch.float32, device=dev)
    if depth_factor is not None:
        depth = depth.float() / depth_factor[:, None, None]
    d = crop_resize_frames(depth, frame_idx, center, scale, input_res)
    Kc = crop_intrinsics(K[frame_idx], center, scale, input_res)
    resize_ratio = out_res / scale
    xyz = backproject_depth(d / resize_ratio[:, None, None], Kc)
    roi_img = torch.cat([img, xyz], dim=-1)                 # [B, S, S, 6]
    lx, ly = coord_axes(H, W, dev)
    yy, xx = torch.meshgrid(ly, lx, indexing="ij")
    coord2d = crop_resize_frames(torch.stack([xx, yy], dim=-1)[None],
                                 torch.zeros_like(frame_idx), center, scale,
                                 out_res)
    stride = input_res // out_res
    roi_coord_2d = torch.cat([xyz[:, ::stride, ::stride], coord2d], dim=-1)
    return roi_img, roi_coord_2d                            # [B, O, O, 5]


def _check(rgb, depth, depth_factor, K, frame_idx, center, scale, input_res,
           out_res, mean, std) -> None:
    ts = [t for t in (rgb, depth, depth_factor, K, frame_idx, center, scale)
          if t is not None]
    if any(t.device != rgb.device for t in ts):
        raise ValueError("roi_crop: inputs on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if rgb.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"roi_crop: rgb must be uint8 or float32, got "
                        f"{rgb.dtype}")
    if depth_factor is None and depth.dtype != torch.float32:
        raise TypeError(f"roi_crop: depth without a factor must be float32 "
                        f"metres, got {depth.dtype}")
    if depth_factor is not None and (depth.dtype != torch.int32
                                     or depth_factor.dtype != torch.float32):
        raise TypeError("roi_crop: raw depth must be int32 with a float32 "
                        f"factor, got {depth.dtype} and {depth_factor.dtype}")
    if frame_idx.dtype != torch.int64:
        raise TypeError(f"roi_crop: int64 frame_idx required, got "
                        f"{frame_idx.dtype}")
    floats = (K, center, scale)
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("roi_crop: float32 K, center and scale required, "
                        f"got {[t.dtype for t in floats]}")
    F, B = rgb.shape[0], frame_idx.shape[0]
    if rgb.dim() != 4 or rgb.shape[3] != 3 or depth.shape != rgb.shape[:3] \
            or (depth_factor is not None and depth_factor.shape != (F,)) \
            or K.shape != (F, 3, 3) or frame_idx.shape != (B,) \
            or center.shape != (B, 2) or scale.shape != (B,):
        raise ValueError(
            "roi_crop: expected rgb [F,H,W,3], depth [F,H,W] (+ "
            "depth_factor [F]), K [F,3,3], frame_idx [B], center [B,2], "
            f"scale [B]; got {[tuple(t.shape) for t in ts]}")
    if F == 0 or rgb.shape[1] == 0 or rgb.shape[2] == 0:
        raise ValueError(f"roi_crop: empty frames {tuple(rgb.shape)}")
    if not 0 < out_res <= input_res <= 4096 \
            or -(-input_res // (input_res // out_res)) != out_res:
        raise ValueError(f"roi_crop: input_res {input_res} and out_res "
                         f"{out_res} must have input_res // out_res as the "
                         "stride of the out_res grid")
    if len(mean) != 3 or len(std) != 3:
        raise ValueError(f"roi_crop: 3 means and 3 stds, got {mean}, {std}")


def roi_crop_cuda(rgb: torch.Tensor, depth: torch.Tensor,
                  depth_factor: torch.Tensor | None, K: torch.Tensor,
                  frame_idx: torch.Tensor, center: torch.Tensor,
                  scale: torch.Tensor, input_res: int, out_res: int,
                  mean: Sequence[float], std: Sequence[float],
                  normalize: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream (arguments as ``roi_crop``;
    CUDA tensors)."""
    _check(rgb, depth, depth_factor, K, frame_idx, center, scale, input_res,
           out_res, mean, std)
    if rgb.device.type != "cuda":
        raise ValueError(f"roi_crop_cuda: CUDA tensors required, got "
                         f"{rgb.device}")
    lib, _ = cuda_build.load(LIBRARY)
    F, H, W, _ = rgb.shape
    B = frame_idx.shape[0]
    if B > 65535:
        raise ValueError(f"roi_crop: B={B} exceeds the grid's y limit")
    if 3 * H * W >= 2 ** 31:
        raise ValueError(f"roi_crop: {H}x{W} frames exceed the kernel's "
                         "32-bit offsets (3 H W < 2^31)")
    rgb, depth, K, frame_idx, center, scale = (
        t.contiguous() for t in (rgb, depth, K, frame_idx, center, scale))
    if depth_factor is not None:
        depth_factor = depth_factor.contiguous()
    dev, S, O = rgb.device, input_res, out_res
    roi_img = torch.empty((B, S, S, 6), dtype=torch.float32, device=dev)
    roi_coord = torch.empty((B, O, O, 5), dtype=torch.float32, device=dev)
    if B == 0:
        return roi_img, roi_coord
    lx, ly = coord_axes(H, W, dev)
    consts = (ctypes.c_float * 3)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = lib.roi_crop_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    iters, _ = roi_crop_plan(B, S, cuda_build.sm_count(dev.index))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(rgb), int(rgb.dtype == torch.uint8), ptr(depth),
                 ptr(depth_factor), ptr(K), ptr(frame_idx), ptr(center),
                 ptr(scale), ptr(lx), ptr(ly), ptr(roi_img), ptr(roi_coord),
                 B, F, H, W, S, O, iters, consts(*mean), consts(*std),
                 int(normalize), stream)
    if err != 0:
        lib.roi_crop_error_string.restype = ctypes.c_char_p
        lib.roi_crop_error_string.argtypes = [ctypes.c_int]
        msg = lib.roi_crop_error_string(err).decode()
        raise RuntimeError(f"roi_crop kernel launch failed: {msg} ({err})")
    cuda_build.count_launch(KERNEL)
    return roi_img, roi_coord


def roi_crop(rgb: torch.Tensor, depth: torch.Tensor,
             depth_factor: torch.Tensor | None, K: torch.Tensor,
             frame_idx: torch.Tensor, center: torch.Tensor,
             scale: torch.Tensor, input_res: int, out_res: int,
             mean: Sequence[float], std: Sequence[float],
             normalize: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The network inputs of B ROIs read from F frames.

    rgb [F,H,W,3] uint8 or float32 (0..255); depth [F,H,W] float32 metres
    with ``depth_factor`` None, or int32 raw units with ``depth_factor``
    [F] float32 (metres = raw / factor); K [F,3,3] float32; frame_idx [B]
    int64, each ROI's frame; center [B,2] (x, y) and scale [B] float32, its
    square window (``ops/warp`` conventions: bilinear taps, pixels off the
    frame 0); input_res S and out_res O with S // O the stride of the O
    grid; mean, std 3 floats each. Returns float32 roi_img [B,S,S,6], the
    crop's RGB ((rgb - mean) / std when ``normalize``) and its depth
    divided by resize_ratio = O / scale and back-projected through the
    crop-composed intrinsics (``crop_intrinsics``), and roi_coord_2d
    [B,O,O,5], that xyz at every stride-th pixel and the crop on the O grid
    of the frame's [0, 1] coordinate map. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    _check(rgb, depth, depth_factor, K, frame_idx, center, scale, input_res,
           out_res, mean, std)
    if rgb.device.type == "cpu":
        return roi_crop_plain(rgb, depth, depth_factor, K, frame_idx, center,
                              scale, input_res, out_res, mean, std, normalize)
    if rgb.device.type == "cuda":
        return roi_crop_cuda(rgb, depth, depth_factor, K, frame_idx, center,
                             scale, input_res, out_res, mean, std, normalize)
    raise ValueError(f"roi_crop: no kernel for device {rgb.device}")
