"""Device ms a train step spends in the kernels launched from
``bench.step``: the step body of ``parallel/train_step`` (the model, the
losses, the backward, Ranger)."""

from port_bench.harness.readers import range_device_ms


def read(run):
    return range_device_ms(run, "bench.step")
