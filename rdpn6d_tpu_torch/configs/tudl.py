"""TUD-L experiment: 3 objects, real training videos, BOP19 test.

The port's own copy of the JAX package's ``configs/tudl.py`` opts: the
all-objects model, 40 epochs, MSSD/MSPD beside the ADD columns, with
``backbone.rot_concat`` on. ``configs/so.py:tudl/<obj>`` is the
per-object protocol.
"""

from rdpn6d_tpu_torch.config import Config

OPTS = [
    'data.train_datasets=["tudl_train_real"]',
    'data.test_datasets=["tudl_bop_test"]',
    "data.color_aug_prob=0.8",
    'data.color_aug_type="code"',
    "data.change_bg_prob=0.5",
    "data.truncate_fg=true",
    "head.num_classes=3",
    "backbone.rot_concat=true",
    "solver.total_epochs=40",
    'test.error_types="ad,adi,AUCad,re,te,proj,mssd,mspd"',
    'backbone.pretrained="torchvision://resnet34"',
    'train.output_dir="output/tudl"',
]


def get_config() -> Config:
    return Config(exp_name="tudl").apply_opts(OPTS)
