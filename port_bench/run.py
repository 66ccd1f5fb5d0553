"""The port's benchmark: one cell of ``BENCHMARK.json`` in one process.

    python3 port_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the checkout's root on a machine with the cell's NVIDIA cards.
The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
the ``breakdown``, and the numbers checked beside their limits under
``checks``); the same numbers end standard error. Without the cards, or
without ``rdpn6d_tpu_torch`` beside it, it exits non-zero and prints no
result.
"""

import os
import sys

if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, ROOT)
    from port_bench.harness.main import main, process_start

    sys.exit(main(sys.argv[1:], ROOT, process_start()))
