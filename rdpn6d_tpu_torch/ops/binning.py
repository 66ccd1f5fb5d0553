"""Coordinate-bin decoding for the CE_coor head mode.

Counterpart of ``rdpn6d_tpu/ops/binning.py:expected_coord_from_bins``.
"""

from __future__ import annotations

import torch


def expected_coord_from_bins(logits: torch.Tensor,
                             num_bins: int) -> torch.Tensor:
    """Softmax expectation over the foreground bins: [..., num_bins+1] ->
    [...]. Bin b maps to b / (num_bins - 1), the reference's normalization
    (the background bin is dropped)."""
    p = torch.softmax(logits[..., :num_bins], dim=-1)
    centers = torch.arange(num_bins, dtype=p.dtype,
                           device=p.device) / float(num_bins - 1)
    return (p * centers).sum(-1)
