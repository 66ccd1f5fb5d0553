"""Torch-convention resizes.

Counterpart of ``rdpn6d_tpu/ops/resize.py``, which writes these as einsums
and strided gathers for the TPU. The reference network upsamples with
bilinear align_corners=True and downsamples xyz with nearest (source index
floor(dst * in / out)); both are ``F.interpolate`` modes here. Unlike the
rest of the port's public functions these take channels FIRST (NCHW), the
layout of the model that calls them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_bilinear_align_corners(x: torch.Tensor, h_out: int,
                                    w_out: int | None = None
                                    ) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True."""
    return F.interpolate(x, size=(h_out, w_out or h_out), mode="bilinear",
                         align_corners=True)


def downsample_nearest_torch(x: torch.Tensor, h_out: int,
                             w_out: int | None = None) -> torch.Tensor:
    """NCHW nearest resize: src index = floor(dst * in / out)."""
    return F.interpolate(x, size=(h_out, w_out or h_out), mode="nearest")
