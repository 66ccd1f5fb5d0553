"""ResNet trunk, PointNet fusion, dense head, Patch-PnP and the RDPN
module."""

from .rdpn import RDPN, init_weights, mask_prob

__all__ = ["RDPN", "init_weights", "mask_prob"]
