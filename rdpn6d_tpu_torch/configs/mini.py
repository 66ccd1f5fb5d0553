"""Mini rehearsal experiment over the generated 3-object dataset.

The port's own copy of the JAX package's ``configs/mini.py`` opts: the
flagship architecture and losses on ``lm_mini_train`` / ``lm_mini_test``
(LM scenes 91 and 92: an asymmetric tetrahedron "ape", a cube "can" with
4-fold discrete symmetry, an L-prism "driller"; ``data/synthetic.
write_mini_tree`` writes them), the symmetric PM loss, the fan-in head
init for a short horizon, and the BOP19 AR with VSD.
"""

from rdpn6d_tpu_torch.config import Config

OPTS = [
    'data.train_datasets=["lm_mini_train"]',
    'data.test_datasets=["lm_mini_test"]',
    "data.color_aug_prob=0.2",
    'data.color_aug_type="code"',
    "solver.ims_per_batch=24",
    "solver.total_epochs=120",
    "solver.warmup_iters=100",
    "loss.pm_loss_sym=true",
    'head.init="fan_in"',
    'test.error_types="ad,adi,AUCad,re,te,proj,vsd,mssd,mspd"',
    'train.output_dir="output/mini"',
]


def get_config() -> Config:
    return Config(exp_name="mini").apply_opts(OPTS)
