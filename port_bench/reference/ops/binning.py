"""Coordinate bins for the CE_coor head mode: quantization of the targets
and the soft decode of the logits.

Counterpart of ``rdpn6d_tpu/ops/binning.py`` (``quantize_coords``,
``expected_coord_from_bins``).
"""

from __future__ import annotations

import torch


def quantize_coords(coord: torch.Tensor, mask: torch.Tensor,
                    num_bins: int) -> torch.Tensor:
    """[..., H, W, 3] coords in [0, 1] -> int32 bins 0..num_bins-1;
    pixels where mask [..., H, W] is 0 take the background bin num_bins."""
    bins = torch.floor(coord.clamp(0.0, 0.999999) * num_bins).to(
        torch.int32)
    return torch.where(mask[..., None] > 0, bins,
                       torch.full_like(bins, num_bins))


def expected_coord_from_bins(logits: torch.Tensor,
                             num_bins: int) -> torch.Tensor:
    """Softmax expectation over the foreground bins: [..., num_bins+1] ->
    [...]. Bin b maps to b / (num_bins - 1), the reference's normalization
    (the background bin is dropped)."""
    p = torch.softmax(logits[..., :num_bins], dim=-1)
    centers = torch.arange(num_bins, dtype=p.dtype,
                           device=p.device) / float(num_bins - 1)
    return (p * centers).sum(-1)
