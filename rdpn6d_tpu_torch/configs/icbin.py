"""IC-BIN experiment: 2 objects in bin-picking clutter, PBR training,
BOP19 test.

The port's own copy of the JAX package's ``configs/icbin.py`` opts: 40
epochs, MSSD/MSPD beside the ADD columns, with ``backbone.rot_concat`` on.
``configs/so.py:icbin/<obj>`` is the per-object protocol.
"""

from rdpn6d_tpu_torch.config import Config

OPTS = [
    'data.train_datasets=["icbin_pbr_train"]',
    'data.test_datasets=["icbin_bop_test"]',
    "data.color_aug_prob=0.8",
    'data.color_aug_type="code"',
    "data.change_bg_prob=0.5",
    "data.truncate_fg=true",
    "head.num_classes=2",
    "backbone.rot_concat=true",
    "solver.total_epochs=40",
    'test.error_types="ad,adi,AUCad,re,te,proj,mssd,mspd"',
    'backbone.pretrained="torchvision://resnet34"',
    'train.output_dir="output/icbin"',
]


def get_config() -> Config:
    return Config(exp_name="icbin").apply_opts(OPTS)
