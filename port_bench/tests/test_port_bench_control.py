"""The control comes out not correct: on the card, at each cell's own
size, on three seeds.

The control is the cell's ``control`` entry for serving (lm13: the
program's own int8-head-static path; the int8 cell: the reference at 4
bits) and the reference with float8 operands for training, each in the
program's place against the reference at the configuration's precision
(bfloat16 autocast in training, the model cast to bfloat16 in serving,
the int8 cell's head emulated at 8 bits). Each seed's control fails
at least one of the cell's limits while the program on the same seed
meets them all. Card only (``-m cuda``); a few minutes a cell:

    python -m pytest -p no:cacheprovider port_bench/tests/test_port_bench_control.py
"""

import json

import pytest

from port_bench.readings import readings
from port_bench.tests.tiny import ROOT

CELLS = ["lm13.train.b96", "lm13.serve.b64", "ycbv.train.pbr.b96",
         "ycbv.serve.int8.b64"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, cuda_device):
    with open(f"{ROOT}/port_bench/workloads/{cell}.json") as f:
        limits = json.load(f)["limits"]
    for line in readings(ROOT, cell, [901, 902, 903], control=True,
                         items=16, device=cuda_device):
        assert all(v <= limits[k] for k, v in line["program"].items()), line
        assert any(v > limits[k] for k, v in line["control"].items()), line
