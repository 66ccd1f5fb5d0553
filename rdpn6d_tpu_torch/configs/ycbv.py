"""YCB-Video experiment.

The port's own copy of the JAX package's ``configs/ycbv.py`` opts
(reference a6_cPnP_AugAAETrunc_BG0.5_Rsym_ycbv_real_pbr_visib20_10e: real
frames with 50% PBR TRAIN2 mixing, instances under 20% visible dropped,
the symmetric PM loss, 21 classes, 10 epochs, ADD(-S) AUC columns), with
the multi-scale skip fusion (``backbone.rot_concat``) on. Background
replacement needs a pool in ``data.bg_images_dir``, as for lmo.
"""

from rdpn6d_tpu_torch.config import Config

OPTS = [
    'data.train_datasets=["ycbv_train_real"]',
    'data.train2_datasets=["ycbv_train_pbr"]',
    "data.train2_ratio=0.5",
    'data.test_datasets=["ycbv_test"]',
    "data.color_aug_prob=0.8",
    'data.color_aug_type="code"',
    "data.change_bg_prob=0.5",
    "data.truncate_fg=true",
    "data.filter_visib_thr=0.2",
    "head.num_classes=21",
    "backbone.rot_concat=true",
    "loss.pm_loss_sym=true",
    "solver.total_epochs=10",
    'test.error_types="AUCadd,AUCadi,AUCad,ad,ABSad"',
    'backbone.pretrained="torchvision://resnet34"',
    'train.output_dir="output/ycbv"',
]


def get_config() -> Config:
    return Config(exp_name="ycbv").apply_opts(OPTS)
