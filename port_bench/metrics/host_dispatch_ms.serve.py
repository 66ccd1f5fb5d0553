"""Median host ms to launch one served batch (preprocessing and the eval
step enqueued, no wait), over the window."""

from port_bench.harness.readers import host_dispatch_ms


def read(run):
    return host_dispatch_ms(run)
