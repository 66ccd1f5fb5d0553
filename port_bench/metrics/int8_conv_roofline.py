"""``csrc/int8_conv.cu`` ``int8_conv``'s share of its roofline over the
head's six launches a batch (``rooflines/int8_conv.py``)."""

from port_bench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "int8_conv")
