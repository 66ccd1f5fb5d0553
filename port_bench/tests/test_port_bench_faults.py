"""A run whose timed path is broken underneath comes out not correct.

Each cell runs tiny on the CPU past the harness's look for a card, with
the cell's own limits, once for each fault it can have: a serving batch
with one answer altered where it is produced, or with half its answers
left out; a training step that leaves the state unchanged, that takes
half of the batch and the mean over it, or whose reported loss is
altered. (No cell spans chips, so none has an exchange to leave out.)
Beside them, a training step whose Lookahead sync keeps the fast weights
(alpha 1 in the program's own Ranger), which the 7 checked steps reach.
"""

import pytest

from port_bench.tests.tiny import run_tiny

CASES = [("lm13.serve.b64", "answer"), ("lm13.serve.b64", "half_batch"),
         ("ycbv.serve.int8.b64", "answer"),
         ("ycbv.serve.int8.b64", "half_batch"),
         ("lm13.train.b96", "unchanged"), ("lm13.train.b96", "half_batch"),
         ("lm13.train.b96", "answer"),
         ("ycbv.train.pbr.b96", "unchanged"),
         ("ycbv.train.pbr.b96", "half_batch"),
         ("ycbv.train.pbr.b96", "answer"),
         ("lm13.train.b96", "lookahead"),
         ("ycbv.train.pbr.b96", "lookahead")]


@pytest.mark.parametrize("cell, fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    # the train cells' program in float32, so a sound tiny run reads 0
    # and what the fault moves is the fault's alone
    opts = ["solver.amp=false"] if ".train." in cell else []
    rc, res = run_tiny(cell, fault=fault, opts=opts)
    assert rc == 0
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ["lm13.train.b96", "ycbv.train.pbr.b96"])
def test_a_sound_float32_run_is_correct(cell):
    rc, res = run_tiny(cell, opts=["solver.amp=false"])
    assert rc == 0 and res["correct"] is True, res["checks"]
