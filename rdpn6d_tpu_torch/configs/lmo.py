"""LineMOD-Occluded experiment.

The port's own copy of the JAX package's ``configs/lmo.py`` opts
(reference a6_cPnP_AugAAETrunc_BG0.5_lmo_real_pbr0.1_40e: real frames
with 10% PBR TRAIN2 mixing, the "code" colour aug at 0.8, background
replacement at 0.5 with truncated foregrounds, 8 classes, 40 epochs, the
torchvision ResNet-34 trunk), with the multi-scale skip fusion
(``backbone.rot_concat``) on. As in the JAX package, background
replacement needs a pool: set ``data.bg_images_dir`` (VOC's
``JPEGImages``, say); without one no background is replaced.
"""

from rdpn6d_tpu_torch.config import Config

OPTS = [
    'data.train_datasets=["lmo_train"]',
    'data.train2_datasets=["lmo_pbr_train"]',
    "data.train2_ratio=0.1",
    'data.test_datasets=["lmo_bop_test"]',
    "data.color_aug_prob=0.8",
    'data.color_aug_type="code"',
    "data.change_bg_prob=0.5",
    "data.truncate_fg=true",
    "head.num_classes=8",
    "backbone.rot_concat=true",
    "solver.total_epochs=40",
    'backbone.pretrained="torchvision://resnet34"',
    'train.output_dir="output/lmo"',
]


def get_config() -> Config:
    return Config(exp_name="lmo").apply_opts(OPTS)
