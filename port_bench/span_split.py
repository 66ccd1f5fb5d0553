"""One traced run of a cell, as ``run.py --trace 1`` makes it, with the
port's own spans read from the same traced sub-window:

    python3 port_bench/span_split.py --workload <cell> --seed <n> \\
        --seconds <s>

Standard output ends in two lines: the harness's result line, unchanged,
then ``{"span_split": ...}`` with each ``rdpn.*`` span's device ms
(inclusive of nested spans) and host self ms an item, the synchronising
runtime calls an item by call and innermost span, the traced window's
idle gaps named by the innermost ``bench.*`` or ``rdpn.*`` range open at
their start, and each ``bench.*`` range's device ms an item to compare
them with (``harness/spans.py`` says how each is attributed). The spans
are reported here, beside the benchmark's metrics, not among them.
"""

import contextlib
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def keeping_events():
    """Within it, each traced sub-window the harness captures also keeps
    its profiler events: yields the list of (``trace.Trace``, events)."""
    from port_bench.harness import trace as htrace

    kept, capture = [], htrace.capture

    def keep(fn, activities):
        import torch

        with torch.profiler.profile(activities=activities) as prof:
            fn()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        trace = htrace.reduce_events(events)
        kept.append((trace, events))
        return trace

    htrace.capture = keep
    try:
        yield kept
    finally:
        htrace.capture = capture


def split(trace, events: list[dict], items: int) -> dict:
    from port_bench.harness.spans import reduce_spans

    out = reduce_spans(events).per_item(items)
    out["ranges_device_ms"] = {
        r: 1e3 * trace.range_seconds(r) / items
        for r in sorted({where for _, _, where in trace.kernels})}
    out["items"] = items
    return out


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from port_bench.harness.main import main, parse, process_start
    from port_bench.harness.manifest import Manifest

    t_start = process_start()
    argv = sys.argv[1:] + ["--trace", "1"]
    with keeping_events() as kept:
        rc = main(argv, ROOT, t_start)
    if rc == 0 and kept:
        items = Manifest(ROOT).cell(parse(argv).workload)["trace_items"]
        print(json.dumps({"span_split": split(*kept[-1], items)}),
              flush=True)
    sys.exit(rc)
