"""Region labels and FPS-residual coordinates (train labels), and the
model-side region gather.

Counterpart of ``rdpn6d_tpu/ops/region.py``. Each foreground pixel of a
cropped object-frame xyz map goes to its nearest FPS keypoint (region
1..K, 0 = background), and the coordinate target is the camera-rotated
residual ``R_gt (xyz - fps[nearest]) / extent + 0.5``.

``region_label`` picks by the tensors' device: CPU tensors take the plain
version, CUDA tensors launch ``csrc/region_label.cu`` (built with nvcc at
first use) or raise. Both take the direct distance form sum_d (x_d - f_d)^2
in float32, with ties to the lowest keypoint index; the TPU path forms the
expanded |x|^2 - 2 x.f + |f|^2 for the MXU (at ``precision="highest"``),
which cancels where the direct form does not. Background pixels (xyz = 0)
still get a coordinate, from the keypoint nearest the origin, as the JAX
package emits it.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

KERNEL = "region_label"


def _foreground(xyz: torch.Tensor) -> torch.Tensor:
    return (xyz[..., 0] != 0) | (xyz[..., 1] != 0) | (xyz[..., 2] != 0)


def _nearest_plain(xyz: torch.Tensor, fps: torch.Tensor) -> torch.Tensor:
    """Index of the nearest keypoint, [B,H,W] int64: the direct form,
    summed x, y, z in that order, first minimum on ties."""
    f = fps[:, None, None]                           # [B,1,1,K,3]
    x = xyz[..., None, :]                            # [B,H,W,1,3]
    d2 = (x[..., 0] - f[..., 0]) ** 2 + (x[..., 1] - f[..., 1]) ** 2 \
        + (x[..., 2] - f[..., 2]) ** 2               # [B,H,W,K]
    return d2.argmin(dim=-1)


def _gather_fps(fps: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """fps [B,K,3] indexed by idx [B,H,W] -> [B,H,W,3]."""
    B, H, W = idx.shape
    flat = idx.reshape(B, H * W, 1).expand(B, H * W, 3)
    return torch.gather(fps, 1, flat).reshape(B, H, W, 3)


def region_label_plain(xyz: torch.Tensor, fps: torch.Tensor,
                       rot: torch.Tensor, extent: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version. xyz [B,H,W,3], fps [B,K,3], rot
    [B,3,3], extent [B,3], float32 -> (region [B,H,W] int32,
    coord [B,H,W,3] float32)."""
    nearest = _nearest_plain(xyz, fps)
    region = torch.where(_foreground(xyz), nearest.to(torch.int32) + 1,
                         torch.zeros((), dtype=torch.int32,
                                     device=xyz.device))
    delta = xyz - _gather_fps(fps, nearest)
    rotated = torch.einsum("bij,bhwj->bhwi", rot, delta)
    return region, rotated / extent[:, None, None, :] + 0.5


def _check(xyz, fps, rot, extent) -> None:
    ts = (xyz, fps, rot, extent)
    if any(t.device != xyz.device for t in ts):
        raise ValueError("region_label: inputs on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("region_label: float32 inputs required, got "
                        f"{[t.dtype for t in ts]}")
    B = xyz.shape[0]
    if xyz.dim() != 4 or xyz.shape[3] != 3 or fps.dim() != 3 \
            or fps.shape[0] != B or fps.shape[2] != 3 \
            or rot.shape != (B, 3, 3) or extent.shape != (B, 3):
        raise ValueError(
            "region_label: expected xyz [B,H,W,3], fps [B,K,3], rot "
            f"[B,3,3], extent [B,3]; got {tuple(xyz.shape)}, "
            f"{tuple(fps.shape)}, {tuple(rot.shape)}, {tuple(extent.shape)}")
    if fps.shape[1] == 0:
        raise ValueError("region_label: no keypoints")


def region_label_cuda(xyz: torch.Tensor, fps: torch.Tensor,
                      rot: torch.Tensor, extent: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream (shapes as
    ``region_label_plain``; CUDA tensors, K <= the kernel's maximum)."""
    _check(xyz, fps, rot, extent)
    if xyz.device.type != "cuda":
        raise ValueError(f"region_label_cuda: CUDA tensors required, got "
                         f"{xyz.device}")
    lib, _ = cuda_build.load(KERNEL)
    B, H, W, _ = xyz.shape
    K = fps.shape[1]
    if K > lib.region_label_max_k():
        raise ValueError(f"region_label: K={K} > {lib.region_label_max_k()}")
    if B > 65535:
        raise ValueError(f"region_label: B={B} exceeds the grid's y limit")
    xyz, fps, rot, extent = (t.contiguous() for t in (xyz, fps, rot, extent))
    region = torch.empty((B, H, W), dtype=torch.int32, device=xyz.device)
    coord = torch.empty((B, H, W, 3), dtype=torch.float32, device=xyz.device)
    if B == 0 or H * W == 0:
        return region, coord
    fn = lib.region_label_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream(xyz.device).cuda_stream
        err = fn(xyz.data_ptr(), fps.data_ptr(), rot.data_ptr(),
                 extent.data_ptr(), region.data_ptr(), coord.data_ptr(),
                 B, H * W, K, stream)
    if err != 0:
        lib.region_label_error_string.restype = ctypes.c_char_p
        lib.region_label_error_string.argtypes = [ctypes.c_int]
        msg = lib.region_label_error_string(err).decode()
        raise RuntimeError(f"region_label kernel launch failed: {msg} "
                           f"({err})")
    cuda_build.count_launch(KERNEL)
    return region, coord


def region_label(xyz: torch.Tensor, fps: torch.Tensor, rot: torch.Tensor,
                 extent: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Region ids and normalized rotated residuals, batched over ROIs.
    CPU tensors take the plain version, CUDA tensors the kernel."""
    _check(xyz, fps, rot, extent)
    if xyz.device.type == "cpu":
        return region_label_plain(xyz, fps, rot, extent)
    if xyz.device.type == "cuda":
        return region_label_cuda(xyz, fps, rot, extent)
    raise ValueError(f"region_label: no kernel for device {xyz.device}")


def residual_coord_target(xyz: torch.Tensor, fps_points: torch.Tensor,
                          rot_gt: torch.Tensor, extent: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The RDPN coordinate target: xyz [B,H,W,3], fps [B,K,3], rot_gt
    [B,3,3], extent [B,3] -> (region [B,H,W] int32 in 0..K,
    coord [B,H,W,3] = R_gt (xyz - fps[region]) / extent + 0.5)."""
    return region_label(xyz, fps_points, rot_gt, extent)


def xyz_to_region(xyz: torch.Tensor, fps_points: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-keypoint region id and raw residual: xyz [B,H,W,3],
    fps [B,K,3] -> (region [B,H,W] int32 in 0..K, 0 = background,
    delta [B,H,W,3] = xyz - fps[nearest])."""
    B = xyz.shape[0]
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device).expand(B, 3, 3)
    region, _ = region_label(xyz, fps_points, eye.contiguous(),
                             torch.ones(B, 3, dtype=xyz.dtype,
                                        device=xyz.device))
    # a background pixel's nearest keypoint is the one nearest the origin
    origin = (fps_points * fps_points).sum(-1).argmin(-1)       # [B]
    nearest = torch.where(region > 0, region.long() - 1,
                          origin[:, None, None])
    return region, xyz - _gather_fps(fps_points, nearest)


def gather_region_fps(fps_points: torch.Tensor,
                      region_ids: torch.Tensor) -> torch.Tensor:
    """Per-pixel FPS keypoint for predicted region ids.

    fps_points [B, K, 3]; region_ids [B, H, W] in 0..K-1 (background
    channel already dropped) -> [B, H, W, 3]."""
    return _gather_fps(fps_points, region_ids)
