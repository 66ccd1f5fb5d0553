"""The FLOPs of one item, counted on the reference at the cell's shapes.

``torch.utils.flop_counter`` over the reference model built on the meta
device: no memory and no compute, only the shapes. Serving counts the
forward in eval mode; training the forward in train mode, the losses and
the backward, with nothing recomputed. The count is the same whatever
implements the step, so a kernel that replaces a convolution cannot move
it.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def count(rcfg, rois: int, train: bool, num_points: int,
          num_sym: int) -> float:
    from ..reference.losses import compute_losses
    from ..reference.models import RDPN

    S, O, K = rcfg.data.input_res, rcfg.data.out_res, rcfg.head.num_regions
    B = rois
    with torch.device("meta"):
        model = RDPN(rcfg)
        f = torch.float32
        batch = {
            "roi_img": torch.empty(B, S, S, 6, dtype=f),
            "roi_coord_2d": torch.empty(B, O, O, 5, dtype=f),
            "fps": torch.empty(B, K, 3, dtype=f),
            "roi_extent": torch.empty(B, 3, dtype=f),
            "roi_cam": torch.empty(B, 3, 3, dtype=f),
            "bbox_center": torch.empty(B, 2, dtype=f),
            "roi_wh": torch.empty(B, 2, dtype=f),
            "resize_ratio": torch.empty(B, dtype=f),
            "roi_cls": torch.zeros(B, dtype=torch.long),
        }
        counter = FlopCounterMode(display=False)
        if not train:
            model.eval()
            with counter, torch.no_grad():
                model(batch)
            return float(counter.get_total_flops())
        batch.update({
            "roi_mask_trunc": torch.empty(B, O, O, dtype=f),
            "roi_mask_visib": torch.empty(B, O, O, dtype=f),
            "roi_mask_obj": torch.empty(B, O, O, dtype=f),
            "roi_xyz": torch.empty(B, O, O, 3, dtype=f),
            "roi_region": torch.zeros(B, O, O, dtype=torch.long),
            "gt_rot": torch.empty(B, 3, 3, dtype=f),
            "gt_trans": torch.empty(B, 3, dtype=f),
            "trans_ratio": torch.empty(B, 3, dtype=f),
            "roi_points": torch.empty(B, num_points, 3, dtype=f),
            "sym_rots": torch.empty(B, num_sym, 3, 3, dtype=f),
        })
        model.train()
        with counter:
            out = model(batch)
            total = sum(compute_losses(rcfg, out, batch).values())
            total.backward()
        return float(counter.get_total_flops())
