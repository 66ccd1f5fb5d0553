"""The serving Predictor."""
