"""Device ms a train step spends in the kernels launched from
``bench.preprocess``:
``data/pipeline.preprocess_rois_grouped(train=True)`` with
``ops/roi_crop``, ``data/augment``, ``ops/gt_labels`` or
``ops/surface_labels``."""

from port_bench.harness.readers import range_device_ms


def read(run):
    return range_device_ms(run, "bench.preprocess")
