"""MP6D metallic-parts experiment (multi-class).

The port's own copy of the JAX package's ``configs/mp6d.py`` opts
(reference configs/gdrn/mp6d/a.py: 25 epochs, the "code" colour aug,
truncated foregrounds with background replacement at 0.5, the ADD(-S) AUC
columns and VSD), with ``backbone.rot_concat`` on. MP6D's ``ycb_style``
records (``-color``/``-depth``/``-label`` PNGs and ``-meta.mat``) are built
by ``data/bop.py``. The published MP6D table trains one model an object:
``configs/so.py:mp6d/<obj>``.
"""

from rdpn6d_tpu_torch.config import Config

OPTS = [
    'data.train_datasets=["mp6d_train"]',
    'data.test_datasets=["mp6d_test"]',
    "data.color_aug_prob=0.8",
    'data.color_aug_type="code"',
    "data.change_bg_prob=0.5",
    "data.truncate_fg=true",
    "head.num_classes=20",
    "backbone.rot_concat=true",
    "solver.total_epochs=25",
    'test.error_types="AUCadd,AUCadi,AUCad,vsd"',
    'backbone.pretrained="torchvision://resnet34"',
    'train.output_dir="output/mp6d"',
]


def get_config() -> Config:
    return Config(exp_name="mp6d").apply_opts(OPTS)
