"""The readings that the limits of ``correct`` are set from.

    python3 port_bench/readings.py --workload <cell> --seeds 11 12 ... \\
        [--control] [--variant] [--faults half_batch ...] [--items 24]

For each seed, in one process: the program's compared numbers as a run
takes them (a serving cell over ``--items`` batches after its warm-up,
its sample drawn from them; a training cell over its checked steps), the
control's on the same batches or steps against the same reference
(``--control``: the cell's ``control`` entry for serving, the reference
with float8 operands for training), a serving cell's reference in
channels_last against the same reference (``--variant``: a sound bf16
path that sums in another order), and each named fault's (the program
with its timed path broken as ``Context.fault`` says; for training also
Ranger's hyperparameters set wrong, ``drivers/train.OPTIMIZER_FAULTS``). One JSON line a
seed on standard output. Needs the cell's cards, as ``run.py`` does.
"""

import argparse
import json
import os
import sys


def readings(root, workload, seeds, control=False, faults=(), items=24,
             device=None, variant=False):
    """Yield one dict a seed: the program's numbers, and the control's and
    each fault's where asked."""
    from port_bench.harness.context import Context, free_device
    from port_bench.harness.loop import run
    from port_bench.harness.manifest import Manifest

    manifest = Manifest(root)
    cell = manifest.cell(workload)
    config = manifest.config(cell["config"])
    drv_mod = manifest.driver(cell["driver"])

    def build(seed, fault=None):
        return drv_mod.Driver(Context(cell, config, seed, device, [], fault))

    def window_of(drv):
        start = getattr(drv, "next_index", 0)
        run(drv_mod, drv, start, count=cell["warmup_items"])
        return run(drv_mod, drv, start + cell["warmup_items"], count=items)

    for seed in seeds:
        line = {"seed": seed}
        drv = build(seed)
        w = window_of(drv)
        drv.release()
        if drv_mod.KIND == "serve":
            idx = drv.sample(list(range(w.start, w.start + w.items)))
            ref = drv.reference_poses(idx, cell.get("reference_bits"))
            line["program"] = drv.compare(drv.poses, ref)
            if control:
                line["control"] = drv.compare(drv.control_poses(idx), ref)
            if variant:
                line["variant"] = drv.compare(drv.variant_poses(idx), ref)
            for fault in faults:
                f = build(seed, fault)
                window_of(f)
                f.release()
                line[fault] = f.compare(f.poses, ref)
                del f
        else:
            ref = drv.reference_steps(bf16=drv.cfg.solver.amp)
            line["program"] = drv.compare(drv.program, ref)
            if control:
                line["control"] = drv.compare(drv.control_steps(), ref)
            for fault in faults:
                f = build(seed, fault)
                f.release()
                line[fault] = f.compare(f.program, ref)
                del f
        del drv
        free_device()
        yield line


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--variant", action="store_true")
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--items", type=int, default=24)
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from port_bench.harness.main import cache_dirs

    cache_dirs(root)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    for line in readings(root, args.workload, args.seeds, args.control,
                         args.faults, args.items, torch.device("cuda", 0),
                         args.variant):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
