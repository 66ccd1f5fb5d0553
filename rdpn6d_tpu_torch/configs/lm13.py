"""LineMOD 13-object experiment: the flagship configuration.

The port's own copy of the JAX package's ``configs/lm13.py`` opts
(reference a6_cPnP_lm13.py: 32 regions, allo_rot6d, centroid_z, Ranger
lr=1e-4, flat_and_anneal cosine @0.72, DZI pad 1.5, color aug off), with
the multi-scale skip fusion (``backbone.rot_concat``) on.
"""

from rdpn6d_tpu_torch.config import Config

OPTS = [
    'data.train_datasets=["lm_13_train", "lm_imgn_13_train_1k_per_obj"]',
    'data.test_datasets=["lm_13_test"]',
    "data.color_aug_prob=0.0",
    'data.color_aug_type="lm"',
    "head.num_classes=13",
    "backbone.rot_concat=true",
    "solver.total_epochs=160",
    "solver.ims_per_batch=24",
    'backbone.pretrained="torchvision://resnet34"',
    'train.output_dir="output/lm13"',
]


def get_config() -> Config:
    return Config(exp_name="lm13").apply_opts(OPTS)
