"""``csrc/roi_crop.cu``'s share of its roofline at the train steps' shapes
(``rooflines/roi_crop.py``)."""

from port_bench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "roi_crop")
