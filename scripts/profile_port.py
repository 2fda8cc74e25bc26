#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one NVIDIA GPU.

    python3 scripts/profile_port.py [--out chiprun_out/profile_port]

Runs `python -m styl3r_tpu_torch.bench.stages` (the serving model at full
width on one 2-view 256^2 scene): each stage's time, and the full forward's
device time, busy share, top kernels and longest gaps from torch.profiler.
The report also goes to `--out`/stages.json.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "profile_port"))
    args = ap.parse_args()
    from styl3r_tpu_torch.bench import stages

    stages.main(["--output", os.path.join(args.out, "stages.json")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
