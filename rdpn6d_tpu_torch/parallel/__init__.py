"""Process groups (``mesh``) and the train steps (``train_step``)."""

from .mesh import (
    all_reduce_sum,
    barrier,
    gather_predictions,
    in_group,
    init_distributed,
    is_main,
    rank,
    replicate,
    spawn,
    world,
)
from .train_step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_sharded_train_step,
    make_train_step,
)

__all__ = ["all_reduce_sum", "barrier", "gather_predictions", "in_group",
           "init_distributed", "is_main", "rank", "replicate", "spawn",
           "world", "TrainState", "create_train_state",
           "make_eval_step", "make_sharded_train_step", "make_train_step"]
