"""Readings that the limits of a cell's compared numbers are set from: the
numbers of sound program runs on many seeds and of the control (the
reference one precision step below the configuration) on a few, in one
process, at the cell's own sizes:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 [--out FILE]

Prints one JSON line a seed, and with --out writes them all as a JSON
list. The benchmark's own runs do not run this."""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from .run import ROOT, cell_files, load_json, set_cache_dirs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="", help="comma-separated fault names of the driver, each on --control-seeds")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    set_cache_dirs()
    import torch

    from .core import Context

    entry, workload, config = cell_files(args.workload, load_json(ROOT / "BENCHMARK.json"))
    driver = importlib.import_module(f"portbench.drivers.{workload['driver']}")
    ctx = Context(cell=args.workload, seed=0, seconds=0.0, trace=False, device=torch.device("cuda", 0),
                  config=config, workload=workload, t_start=time.perf_counter(),
                  log=lambda msg: print(msg, file=sys.stderr, flush=True))
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    kwargs = {"faults": [f for f in args.faults.split(",") if f]} if args.faults else {}
    rows = driver.readings(ctx, ints(args.seeds), ints(args.control_seeds), **kwargs)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
