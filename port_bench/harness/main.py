"""One run of one cell: set-up, the measured window, a traced sub-window
with ``--trace 1``, the check against the reference, the result line.

``main`` is the command line; ``execute`` is the run itself on a device,
which the tests call on the CPU at tiny widths (the command line refuses
a machine without the cell's cards).
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "rdpn6d_tpu")


def process_start() -> float:
    """The wall-clock time this process started (Linux: from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="port_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``rdpn6d_tpu_torch`` is not ``rdpn6d_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its kernels into ``rdpn6d_tpu_torch/_build/`` itself)."""
    base = os.path.join(root, "port_bench", ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def card_line(query: str = "name,power.limit") -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv: list[str], root: str, t_start: float) -> int:
    args = parse(argv)
    from .manifest import Manifest

    manifest = Manifest(root)
    cell = manifest.cell(args.workload)
    cache_dirs(root)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    print(f"port_bench: {args.workload} seed {args.seed} on "
          f"{card_line()}", file=sys.stderr)
    return execute(manifest, cell, args, torch.device("cuda", 0), t_start)


def execute(manifest, cell: dict, args, device, t_start: float,
            extra_opts: list | None = None, fault: str | None = None,
            out=None) -> int:
    import torch

    from . import trace as htrace
    from .context import Context
    from .loop import fifths, run as run_items
    from .readers import Run

    out = out or sys.stdout
    torch.set_num_threads(2)
    drv_mod = manifest.driver(cell["driver"])
    ctx = Context(cell, manifest.config(cell["config"]), args.seed, device,
                  list(extra_opts or []), fault)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    t_driver = time.time()
    driver = drv_mod.Driver(ctx)
    t_warm = time.time()
    start = getattr(driver, "next_index", 0)
    warm = run_items(drv_mod, driver, start, count=cell["warmup_items"])
    start += warm.items
    if cuda:
        torch.cuda.synchronize(device)
    # the set-up's objects out of the collector's way in the window
    gc.collect()
    gc.freeze()
    setup_s = time.time() - t_start
    print(f"port_bench: set-up {setup_s:.1f} s: to the driver "
          f"{t_driver - t_start:.1f}, the driver {t_warm - t_driver:.1f}, "
          f"warm-up {time.time() - t_warm:.1f}", file=sys.stderr)

    window = run_items(drv_mod, driver, start, seconds=args.seconds)
    start += window.items
    print("port_bench: items a second by fifth of the window "
          + " ".join(f"{r:.2f}" for r in fifths(window)), file=sys.stderr)
    if cuda:
        print("port_bench: after the window "
              + card_line("clocks.sm,clocks.mem,power.draw,temperature.gpu"),
              file=sys.stderr)
    metrics: dict[str, dict] = {}
    breakdown = None
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else device.type, "count": 1}
    if args.trace:
        n = cell["trace_items"]

        def traced():
            run_items(drv_mod, driver, start, count=n)
            if cuda:
                torch.cuda.synchronize(device)

        acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        trace = htrace.capture(traced, acts)
        shapes: dict[str, list] = {}
        for i in range(start, start + n):
            for k, v in driver.kernel_shapes(i).items():
                shapes.setdefault(k, []).extend(v)
        flops = getattr(drv_mod, "flops_per_item", None)
        per_item = flops(driver) if flops is not None else None
        run = Run(trace, n, window.items / window.seconds, per_item,
                  window.dispatch_s, shapes, manifest)
        for m in manifest.per_layer(cell["name"]):
            value = manifest.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=trace.busy_s, window_s=trace.window_s)
        breakdown = trace.breakdown()
    else:
        e2e = drv_mod.end_to_end(window, setup_s)
        for m in manifest.end_to_end(cell["name"]):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    if cuda:
        torch.cuda.synchronize(device)
        device_info["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
    else:
        device_info["memory_peak_bytes"] = 0
    driver.release()
    numbers = driver.check(window)
    limits = cell["limits"]
    correct = True
    checks = {}
    for name in limits:
        value = numbers[name]
        ok = math.isfinite(value) and value <= limits[name]
        correct &= ok
        checks[name] = {"value": value, "limit": limits[name]}
    attempted = warm.items + window.items
    failed = warm.failed + window.failed
    correct &= failed == 0
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded {found}: the run is refused",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0

