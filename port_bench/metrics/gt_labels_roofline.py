"""``csrc/region_label.cu`` ``gt_labels``'s share of its roofline
(``rooflines/gt_labels.py``)."""

from port_bench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "gt_labels")
