"""Device kernels launched per served batch in the traced sub-window (a
count)."""

from port_bench.harness.readers import launches_per_item


def read(run):
    return launches_per_item(run)
