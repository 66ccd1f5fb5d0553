"""HomebrewedDB experiment: 33 objects, PBR training.

The port's own copy of the JAX package's ``configs/hb.py`` opts. BOP
withholds HB's test GT, so ``hb_bop_test`` is the ``val_primesense``
scenes. 40 epochs, MSSD/MSPD beside the ADD columns, with
``backbone.rot_concat`` on. ``configs/so.py:hb/<obj>`` is the per-object
protocol.
"""

from rdpn6d_tpu_torch.config import Config

OPTS = [
    'data.train_datasets=["hb_pbr_train"]',
    'data.test_datasets=["hb_bop_test"]',
    "data.color_aug_prob=0.8",
    'data.color_aug_type="code"',
    "data.change_bg_prob=0.5",
    "data.truncate_fg=true",
    "head.num_classes=33",
    "backbone.rot_concat=true",
    "solver.total_epochs=40",
    'test.error_types="ad,adi,AUCad,re,te,proj,mssd,mspd"',
    'backbone.pretrained="torchvision://resnet34"',
    'train.output_dir="output/hb"',
]


def get_config() -> Config:
    return Config(exp_name="hb").apply_opts(OPTS)
