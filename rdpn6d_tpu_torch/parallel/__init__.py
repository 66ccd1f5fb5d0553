"""The train step (single device; DDP is not ported yet)."""

from .train_step import TrainState, create_train_state, make_train_step

__all__ = ["TrainState", "create_train_state", "make_train_step"]
