"""Share of the traced sub-window of train steps in which no kernel, copy
or memset runs on the card."""

from port_bench.harness.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
