"""T-LESS experiment: 30 texture-less industrial objects, many symmetric.

The port's own copy of the JAX package's ``configs/tless.py`` opts: the
all-objects model on the Primesense real train scenes, scored on the BOP19
``test_primesense`` targets (720x540 frames) with the symmetric PM loss,
40 epochs, and the BOP19 MSSD/MSPD recalls beside the ADD columns; with
``backbone.rot_concat`` on. ``configs/so.py:tless/<obj>`` is the
per-object protocol.
"""

from rdpn6d_tpu_torch.config import Config

OPTS = [
    'data.train_datasets=["tless_primesense_train"]',
    'data.test_datasets=["tless_bop_test"]',
    "data.color_aug_prob=0.8",
    'data.color_aug_type="code"',
    "data.change_bg_prob=0.5",
    "data.truncate_fg=true",
    "head.num_classes=30",
    "backbone.rot_concat=true",
    "loss.pm_loss_sym=true",
    "solver.total_epochs=40",
    'test.error_types="ad,adi,AUCad,re,te,proj,mssd,mspd"',
    'backbone.pretrained="torchvision://resnet34"',
    'train.output_dir="output/tless"',
]


def get_config() -> Config:
    return Config(exp_name="tless").apply_opts(OPTS)
