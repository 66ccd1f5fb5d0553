"""ITODD experiment: 28 gray-scale industrial objects, PBR training.

The port's own copy of the JAX package's ``configs/itodd.py`` opts (BOP
withholds the test GT, so ``itodd_bop_test`` is the val scene; symmetric
PM loss, 40 epochs), with ``backbone.rot_concat`` on. ITODD's val frames
are gray TIFF files (``gray/*.tif``), read by ``data/tif.py`` as OpenCV
reads them in colour; its 960x1280 frames are the largest of the
configs.
"""

from rdpn6d_tpu_torch.config import Config

OPTS = [
    'data.train_datasets=["itodd_pbr_train"]',
    'data.test_datasets=["itodd_bop_test"]',
    "data.color_aug_prob=0.8",
    'data.color_aug_type="code"',
    "data.change_bg_prob=0.5",
    "data.truncate_fg=true",
    "head.num_classes=28",
    "backbone.rot_concat=true",
    "loss.pm_loss_sym=true",
    "solver.total_epochs=40",
    'test.error_types="ad,adi,AUCad,re,te,proj,mssd,mspd"',
    'backbone.pretrained="torchvision://resnet34"',
    'train.output_dir="output/itodd"',
]


def get_config() -> Config:
    return Config(exp_name="itodd").apply_opts(OPTS)
