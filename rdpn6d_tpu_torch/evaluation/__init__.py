"""Pose errors, the PoseEvaluator, recall/AUC scoring, recall curves,
BOP19 errors and average recalls."""
