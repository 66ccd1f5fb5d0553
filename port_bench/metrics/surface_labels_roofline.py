"""``csrc/region_label.cu`` ``surface_labels``'s share of its roofline
(``rooflines/surface_labels.py``)."""

from port_bench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "surface_labels")
