"""A whole run of a cell on the CPU at tiny widths, for the tests: the
cell's own files with its sizes cut and the widths of the config's opts
shrunk (``TINY``), the driver and the reference as the command runs them.
"""

from __future__ import annotations

import io
import json
import os
import time
from argparse import Namespace

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16", "pnp.featdim=32", "loss.num_pm_points=64"]
SMALL = {"frame_hw": [96, 128], "pool": 2, "draw_steps": 16,
         "noise_batches": 16, "warmup_items": 1, "trace_items": 2,
         "check_batches": 2, "checked_steps": 7}


def small_cell(manifest, name: str) -> dict:
    cell = dict(manifest.cell(name), **SMALL)
    cell["rois"] = 4
    cell["frames"] = 4 if cell["frames"] == cell["rois"] * 16 else 2
    cell["crop"] = 64
    cell["z_range"] = [0.9 * z for z in cell["z_range"]]
    return cell


def run_tiny(name: str, seed: int = 7, seconds: float = 0.5,
             trace: int = 0, fault: str | None = None,
             limits: dict | None = None, opts: list | None = None,
             root: str = ROOT) -> tuple[int, dict]:
    from port_bench.harness.main import execute
    from port_bench.harness.manifest import Manifest

    manifest = Manifest(root)
    cell = small_cell(manifest, name)
    if limits is not None:
        cell["limits"] = limits
    out = io.StringIO()
    args = Namespace(workload=name, seed=seed, seconds=seconds, trace=trace)
    rc = execute(manifest, cell, args, torch.device("cpu"), time.time(),
                 extra_opts=TINY + list(opts or []), fault=fault,
                 out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else {}
