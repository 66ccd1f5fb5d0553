"""ROI crop-resize with the CenterNet affine convention, as a gather.

Counterpart of ``rdpn6d_tpu/ops/warp.py`` (``crop_affine``, ``crop_resize``;
the TPU path's ``crop_resize_mm`` computes the same crop as Wy·img·Wxᵀ
matmuls for the MXU). With rot=0 and a square source window the affine is a
uniform scale-and-translate:

    dst_x = r * (src_x - cx) + out / 2,   r = out / scale

Bilinear matches cv2.INTER_LINEAR with BORDER_CONSTANT(0); nearest matches
cv2.INTER_NEAREST, whose rounding is half-to-even (``torch.round``). Pixel
centers sit at integer coordinates. Every function takes channels last,
as the JAX package does.
"""

from __future__ import annotations

import torch


def crop_affine(center: torch.Tensor, scale: torch.Tensor,
                out_size: int) -> torch.Tensor:
    """2x3 src->dst affine for a square crop. center [..., 2], scale [...]."""
    r = out_size / scale
    zeros = torch.zeros_like(r)
    row0 = torch.stack([r, zeros, out_size / 2.0 - r * center[..., 0]], -1)
    row1 = torch.stack([zeros, r, out_size / 2.0 - r * center[..., 1]], -1)
    return torch.stack([row0, row1], dim=-2)


def _src_coords(centers: torch.Tensor, scales: torch.Tensor,
                out_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-ROI source coordinates (sx, sy), each [B, out]."""
    # a tensor divisor: on CUDA, torch multiplies by the reciprocal of a
    # Python-number divisor, which may round r an ulp off scale / out and
    # move a nearest tap; divided by a tensor, r rounds alike on every
    # device and in csrc/region_label.cu's gt_labels
    r = (scales / torch.full_like(scales, out_size))[:, None]
    grid = torch.arange(out_size, dtype=torch.float32,
                        device=centers.device) - out_size / 2.0
    return centers[:, 0:1] + grid * r, centers[:, 1:2] + grid * r


def crop_resize_frames(frames: torch.Tensor, frame_idx: torch.Tensor,
                       centers: torch.Tensor, scales: torch.Tensor,
                       out_size: int, interp: str = "bilinear"
                       ) -> torch.Tensor:
    """Crop many square ROIs out of a stack of frames.

    frames [F, H, W, C] or [F, H, W] (any dtype; taps are read in it and
    weighted in float32); frame_idx [B] int; centers [B, 2] (x, y);
    scales [B] side lengths -> float32 [B, out, out(, C)].
    """
    squeeze = frames.dim() == 3
    if squeeze:
        frames = frames[..., None]
    H, W = frames.shape[1], frames.shape[2]
    sx, sy = _src_coords(centers.float(), scales.float(), out_size)
    f = frame_idx.long()[:, None, None]

    def tap(yi, xi):
        valid = (((xi >= 0) & (xi < W))[:, None, :]
                 & ((yi >= 0) & (yi < H))[:, :, None])       # [B, out, out]
        g = frames[f, yi.clamp(0, H - 1)[:, :, None],
                   xi.clamp(0, W - 1)[:, None, :]].float()   # [B,o,o,C]
        return g * valid[..., None]

    if interp == "nearest":
        out = tap(torch.round(sy).long(), torch.round(sx).long())
    elif interp == "bilinear":
        x0, y0 = torch.floor(sx), torch.floor(sy)
        fx = (sx - x0)[:, None, :, None]   # [B, 1, out, 1]
        fy = (sy - y0)[:, :, None, None]   # [B, out, 1, 1]
        x0i, y0i = x0.long(), y0.long()
        out = (tap(y0i, x0i) * (1 - fy) * (1 - fx)
               + tap(y0i, x0i + 1) * (1 - fy) * fx
               + tap(y0i + 1, x0i) * fy * (1 - fx)
               + tap(y0i + 1, x0i + 1) * fy * fx)
    else:
        raise ValueError(f"unknown interp: {interp}")
    return out[..., 0] if squeeze else out


def crop_resize(img: torch.Tensor, center: torch.Tensor, scale,
                out_size: int, interp: str = "bilinear") -> torch.Tensor:
    """One square window (center [2], side ``scale``) of img [H, W(, C)]
    resized to out_size² -> float32 [out, out(, C)]; out of bounds is 0."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=img.device)
    zero = torch.zeros(1, dtype=torch.long, device=img.device)
    return crop_resize_frames(img[None], zero, center[None],
                              scale.reshape(1), out_size, interp)[0]
