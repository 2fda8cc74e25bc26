"""On the card, at each cell's own sizes: a sound run of the program reads
within every limit of its workload file, and the control (the reference
one precision step below the configuration, portbench/reference/lowprec.py)
reads over at least one. Marked `cuda`; skips without a card:

    python3 -m pytest -m cuda portbench/tests/test_portbench_cuda.py
"""

from __future__ import annotations

import importlib
import sys
import time

import pytest

from portbench import run
from portbench.core import Context

CELLS = [w["name"] for w in run.load_json(run.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes_and_the_control_fails(card, cell):
    _, wl, cfg = run.cell_files(cell, run.load_json(run.ROOT / "BENCHMARK.json"))
    driver = importlib.import_module(f"portbench.drivers.{wl['driver']}")
    ctx = Context(cell=cell, seed=0, seconds=0.0, trace=False, device=card, config=cfg, workload=wl,
                  t_start=time.perf_counter(), log=lambda m: print(m, file=sys.stderr))
    program, control = driver.readings(ctx, [2**31 + 5], [2**31 + 6])
    limits = wl["check"]["limits"]
    assert all(program[k] <= v for k, v in limits.items()), program
    assert any(control[k] > v for k, v in limits.items()), control
