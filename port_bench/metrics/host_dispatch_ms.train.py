"""Median host ms to launch one train step (preprocessing and the step
enqueued), over the window."""

from port_bench.harness.readers import host_dispatch_ms


def read(run):
    return host_dispatch_ms(run)
