"""BENCHMARK.json against the benchmark's contract, and every name found
by its file; a throwaway cell added by files alone."""

import json
import os
import re
import shutil

import pytest

from port_bench.harness.manifest import Manifest
from port_bench.tests.tiny import ROOT, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    return Manifest(ROOT)


def test_keys_and_sizes(manifest):
    d = manifest.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(d)) <= 64 * 1024
    assert 1 <= len(d["paths"]) <= 16 and 1 <= len(d["command"]) <= 32
    assert 1 <= d["run_seconds"] <= 51
    for p in d["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
    for word in d["command"]:
        assert LINE.match(word) and not word.startswith("/")
    assert 1 <= len(d["configs"]) <= 24 and 1 <= len(d["workloads"]) <= 24
    assert 1 <= len(d["end_to_end"]) <= 16
    assert 1 <= len(d["per_layer"]) <= 128


def test_names_units_and_lines(manifest):
    d = manifest.data
    names = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    assert len(names) == len(set(names))
    for c in d["configs"]:
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    pairs = set()
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(d["workloads"])
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in d["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in d["end_to_end"])
    for m in d["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in d["end_to_end"]}
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in
                                  manifest.end_to_end(cell)}


def test_every_name_is_found(manifest):
    d = manifest.data
    for c in d["configs"]:
        cfg = manifest.config(c["name"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in d["workloads"]:
        cell = manifest.cell(w["name"])
        assert manifest.driver(cell["driver"]).KIND in ("serve", "train")
        e2e = {m["name"] for m in manifest.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer(w["name"])
    for m in d["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)
    for k in ("roi_crop", "gt_labels", "surface_labels", "int8_conv"):
        f = manifest.roofline(k)
        assert f.KERNEL.endswith("_kernel") and callable(f.bound_s)


def test_a_cell_added_by_files_alone(tmp_path):
    """A throwaway cell, its own workload file and a BENCHMARK.json entry,
    in a copy of the benchmark: found by name and run end to end."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "port_bench"), root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(root / "port_bench" / "workloads" / "lm13.serve.b64.json") as f:
        spec = json.load(f)
    spec["rois"] = 32
    with open(root / "port_bench" / "workloads" / "lm13.serve.b32.json",
              "w") as f:
        json.dump(spec, f)
    bench["workloads"].append({"name": "lm13.serve.b32", "config": "lm13",
                               "traffic": "serve.b32", "chips": 1,
                               "why": "a throwaway cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lm13.serve.b64" in m.get("workloads", []):
            m["workloads"].append("lm13.serve.b32")
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    m = Manifest(str(root))
    assert m.cell("lm13.serve.b32")["rois"] == 32
    assert "poses_per_s" in {e["name"] for e in m.end_to_end(
        "lm13.serve.b32")}
    rc, res = run_tiny("lm13.serve.b32", root=str(root))
    assert rc == 0 and set(res["metrics"]) == {
        "poses_per_s", "request_p95_ms", "setup_s"}


SERIAL_DRIVER = '''"""A throwaway driver: the serving driver under a loop and end-to-end
metrics of its own (one batch at a time, read back before the next)."""
import os

from port_bench.harness.loop import closed_loop
from port_bench.harness.manifest import _load_module

_serve = _load_module(os.path.join(os.path.dirname(__file__), "serve.py"),
                      "throwaway_serve")
KIND, ANSWER, Driver = _serve.KIND, _serve.ANSWER, _serve.Driver
flops_per_item = _serve.flops_per_item


def window(driver, start, seconds=None, count=None):
    return closed_loop(lambda i: driver.collect(i, driver.launch(i)),
                       lambda i, done: done, start, seconds=seconds,
                       count=count)


def end_to_end(window, setup_s):
    return {"serial_batches_per_s": window.items / window.seconds,
            "setup_s": setup_s}
'''


def test_a_driver_added_by_files_alone(tmp_path):
    """A throwaway driver with its own window and end-to-end metric, and a
    cell that names it: new files and entries alone, run end to end."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "port_bench"), root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    (root / "port_bench" / "drivers" / "serve_serial.py").write_text(
        SERIAL_DRIVER)
    with open(root / "port_bench" / "workloads" / "lm13.serve.b64.json") as f:
        spec = json.load(f)
    spec["driver"] = "serve_serial"
    with open(root / "port_bench" / "workloads" / "lm13.serial.json",
              "w") as f:
        json.dump(spec, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "lm13.serial", "config": "lm13",
                               "traffic": "serial", "chips": 1,
                               "why": "a throwaway cell"})
    bench["end_to_end"].append({
        "name": "serial_batches_per_s", "unit": "batches/s",
        "better": "higher", "bound": 0.25, "source": "host_clock",
        "workloads": ["lm13.serial"]})
    for m in bench["end_to_end"]:
        if m["name"] == "setup_s" and "workloads" in m:
            m["workloads"].append("lm13.serial")
    bench["per_layer"].append({
        "name": "device_idle_pct.serial", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "the device",
        "moves": "serial_batches_per_s", "workloads": ["lm13.serial"]})
    shutil.copy(root / "port_bench" / "metrics" / "device_idle_pct.serve.py",
                root / "port_bench" / "metrics" / "device_idle_pct.serial.py")
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    rc, res = run_tiny("lm13.serial", root=str(root))
    assert rc == 0 and res["correct"] is True, res
    assert set(res["metrics"]) == {"serial_batches_per_s", "setup_s"}
    rc, res = run_tiny("lm13.serial", root=str(root), trace=1)
    assert rc == 0 and set(res["metrics"]) == {"device_idle_pct.serial"}
