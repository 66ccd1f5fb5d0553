"""Base experiment: the flagship RDPN shape with every default.

The port's own copy of the JAX package's ``configs/base.py``: ResNet-34,
256 -> 64, 32 regions, allo_rot6d with centroid/z, Ranger under
flat_and_anneal, and no dataset named (pass them through ``--opts``).
"""

from rdpn6d_tpu_torch.config import Config


def get_config() -> Config:
    return Config()
