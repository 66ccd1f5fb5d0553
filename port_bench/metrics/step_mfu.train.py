"""The whole train step's share of the card's dense bf16 peak: the
reference's FLOPs of one step (forward, losses, backward) times the
window's steps a second."""

from port_bench.harness.readers import step_mfu_pct


def read(run):
    return step_mfu_pct(run)
