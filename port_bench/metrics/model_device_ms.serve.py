"""Device ms a served batch spends in the kernels launched from
``bench.model``: ``parallel/train_step.make_eval_step`` over
``models/rdpn`` and ``geometry/camera``."""

from port_bench.harness.readers import range_device_ms


def read(run):
    return range_device_ms(run, "bench.model")
