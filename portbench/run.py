"""Runs one cell of the benchmark once and prints its result as the last
line of standard output:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json at the repository's
root. Its workload file, portbench/workloads/<cell>.json, names the
configuration (portbench/configs/<config>.json) and the traffic driver
(portbench/drivers/<driver>.py) that builds the program, warms up, runs the
window and checks the answers against the reference. With --trace 0 the
result holds the cell's end-to-end metrics; with --trace 1 its per-layer
metrics, each read by portbench/metrics/<metric>.py from the driver's
record, and the device's busy and window seconds of a profiled slice.

Exit codes: 0 with a result; 2 for an unknown cell; 3 when the program
(styl3r_tpu_torch) is missing; 4 without the CUDA devices the cell asks
for; 5 when JAX, flax or the JAX package was loaded. The numbers that
decide `correct` are printed, each beside its limit, as the last lines of
standard error and under the result's last key, `checks`."""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """perf_counter's reading at the moment this process started (Linux's
    /proc; the module's import time elsewhere)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
# Caches of whatever the program builds, at fixed paths inside the checkout.
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "styl3r_tpu")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(code: int, msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str, bench: dict):
    """(BENCHMARK.json's entry, the workload file, the configuration file)
    of a cell, found by name."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        return None
    return entry, load_json(HERE / "workloads" / f"{name}.json"), load_json(HERE / "configs" / f"{entry['config']}.json")


def reports(metric: dict, cell: str, end_to_end_names) -> bool:
    """Whether `cell` reports `metric`: it is listed, or the metric lists no
    cells and (for a per-layer metric) the cell reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in end_to_end_names


def cell_metrics(bench: dict, cell: str):
    e2e = [m for m in bench["end_to_end"] if reports(m, cell, ())]
    names = {m["name"] for m in e2e}
    return e2e, [m for m in bench["per_layer"] if reports(m, cell, names)]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_').replace('-', '_')}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def set_cache_dirs() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    args = parse_args(argv)
    set_cache_dirs()
    bench = load_json(ROOT / "BENCHMARK.json")
    found = cell_files(args.workload, bench)
    if found is None:
        fail(2, f"no cell {args.workload!r} in BENCHMARK.json")
    entry, workload, config = found
    if importlib.util.find_spec("styl3r_tpu_torch") is None:
        fail(3, "the program under test, styl3r_tpu_torch, is not in this checkout")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        fail(4, f"the cell needs {entry['chips']} CUDA device(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    from .core import Context

    driver = importlib.import_module(f"portbench.drivers.{workload['driver']}")
    ctx = Context(cell=args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=torch.device("cuda", 0), config=config, workload=workload, t_start=T_START,
                  log=lambda msg: print(msg, file=sys.stderr, flush=True))
    result = result_of(ctx, driver.run(ctx), bench, entry)
    bad = forbidden_modules()
    if bad:
        fail(5, f"the run loaded {', '.join(bad)}")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def result_of(ctx, outcome, bench: dict, entry: dict) -> dict:
    """The result line's object from a driver's outcome."""
    import torch

    e2e, per_layer = cell_metrics(bench, ctx.cell)
    metrics = {}
    if ctx.trace:
        for m in per_layer:
            value = reader(m["name"])(outcome.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            value = ctx.setup_s if m["name"] == "setup_s" else outcome.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = ctx.device.type == "cuda"
    device = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
        "count": entry["chips"],
        "memory_peak_bytes": outcome.memory_peak_bytes,
    }
    result = {"correct": None, "attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics,
              "device": device}
    trace = outcome.record.get("trace")
    if ctx.trace and trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    checks = {name: (float(v), float(limit)) for name, (v, limit) in outcome.checks.items()}
    result["correct"] = bool(checks) and all(math.isfinite(v) and v <= limit for v, limit in checks.values())
    result["checks"] = {name: {"value": v if math.isfinite(v) else repr(v), "limit": limit}
                        for name, (v, limit) in checks.items()}
    return result


if __name__ == "__main__":
    sys.exit(main())
