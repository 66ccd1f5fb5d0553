"""The serving Predictor, the Trainer, checkpoints, inference and the
split eval runner."""
