"""Eval-half ROI preprocessing and per-class assets."""
