from .rdpn import RDPN, mask_prob

__all__ = ["RDPN", "mask_prob"]
