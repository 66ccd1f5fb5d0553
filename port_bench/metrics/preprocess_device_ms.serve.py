"""Device ms a served batch spends in the kernels launched from the
benchmark's ``bench.preprocess`` range:
``data/pipeline.preprocess_rois_grouped(train=False)`` and
``ops/roi_crop``."""

from port_bench.harness.readers import range_device_ms


def read(run):
    return range_device_ms(run, "bench.preprocess")
