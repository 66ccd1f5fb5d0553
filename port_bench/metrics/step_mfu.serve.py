"""The whole served batch's share of the card's dense bf16 peak: the
reference's FLOPs of one batch times the window's batches a second."""

from port_bench.harness.readers import step_mfu_pct


def read(run):
    return step_mfu_pct(run)
