"""Finding a cell, its configuration, its driver and its metrics by name.

``BENCHMARK.json`` at the checkout's root names them; each lives in a
file of its own under ``port_bench/``: ``workloads/<cell>.json`` (the
traffic and the driver's parameters), ``configs/<config>.json`` (the
port's opts and the dataset's classes and camera), ``drivers/<driver>.py``
(the items, their ``end_to_end`` metrics and ``flops_per_item``, and a
``window`` loop where the closed loop does not serve),
``metrics/<metric>.py`` (a reader of a traced run)
and ``rooflines/<kernel>.py`` (a kernel's least time from its shapes). A
new cell, configuration or metric is new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

BENCH_DIR = "port_bench"


def _load_module(path: str, name: str) -> ModuleType:
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def path(self, *parts: str) -> str:
        return os.path.join(self.root, BENCH_DIR, *parts)

    def cell(self, name: str) -> dict:
        """The cell's manifest entry merged with its workload file."""
        if name not in self.cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        entry = self.cells[name]
        with open(self.path("workloads", f"{name}.json")) as f:
            spec = json.load(f)
        if spec["config"] != entry["config"]:
            raise ValueError(f"{name}: workload file names config "
                             f"{spec['config']!r}, BENCHMARK.json "
                             f"{entry['config']!r}")
        return {**spec, "name": name, "chips": entry["chips"]}

    def config(self, name: str) -> dict:
        if name not in self.configs:
            raise KeyError(f"no config {name!r} in BENCHMARK.json")
        with open(os.path.join(self.root, self.configs[name]["file"])) as f:
            return json.load(f)

    def driver(self, name: str) -> ModuleType:
        return _load_module(self.path("drivers", f"{name}.py"),
                            f"port_bench_driver_{name}")

    def roofline(self, kernel: str) -> ModuleType:
        return _load_module(self.path("rooflines", f"{kernel}.py"),
                            f"port_bench_roofline_{kernel}")

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics read in ``cell``: those listing it, and
        those without a list that move an end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric: str) -> ModuleType:
        return _load_module(self.path("metrics", f"{metric}.py"),
                            f"port_bench_metric_{metric.replace('.', '_')}")
