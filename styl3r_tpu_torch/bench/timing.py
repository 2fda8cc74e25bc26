"""Clocks and profiler readings of the measurement entry points.

Device times come from CUDA events on the card; on the CPU the same
functions read the host clock, and what only the card can measure (the
profiler's device time, host synchronisations) is None there.
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile
import time
import warnings
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import Tensor

from ..device import card_line  # noqa: F401  (the measurement scripts' import of it)

ROOT = Path(__file__).resolve().parents[2]


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Median milliseconds of `reps` calls, each between two CUDA events."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_device_ms(fn, reps, kernel_names, attempts=5):
    """Device time of one call of `fn`, summed over the CUDA kernels it
    launches, from torch.profiler over `reps` calls: each name in
    `kernel_names` must match kernels launched once a call. Returns the sum,
    each kernel's mean time a call (the kernels' own time, without the
    host's time to call them) and each kernel's launch shape in the same
    calls (launch_shapes). The profiler on the card now and then records
    fewer launches than were made, in some windows none; such a window is
    measured again, up to `attempts` times, and if none is whole, each
    kernel's mean is taken over the launches the profiler saw in the window
    where the fewest were lost (every kernel seen at least once)."""
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        counts, each = {}, {}
        for name in kernel_names:
            hits = [e for e in prof.key_averages() if name in e.key]
            counts[name] = sum(e.count for e in hits)
            if counts[name]:
                each[name] = sum(e.self_device_time_total for e in hits) / counts[name] / 1e3
        if any(c > reps for c in counts.values()):
            raise AssertionError(f"profiler saw {counts} launches in {reps} calls: a name matches other kernels")
        if all(c == reps for c in counts.values()):
            return sum(each.values()), each, launch_shapes(prof, kernel_names)
        log(f"profiler saw {counts} launches, expected {reps} of each; measuring again")
        if min(counts.values()) > 0 and (best is None or min(counts.values()) > min(best[0].values())):
            best = (counts, each, launch_shapes(prof, kernel_names))
    if best is None:
        raise AssertionError(f"profiler saw no launch of a kernel of {kernel_names} in {attempts} windows")
    counts, each, shapes = best
    log(f"profiler: no whole window in {attempts}; each kernel's mean over the {counts} launches it saw")
    return sum(each.values()), each, shapes


def trace_events(prof) -> List[dict]:
    """The chrome trace's event list of a finished torch.profiler window."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def launch_shapes(prof, kernel_names):
    """Each named kernel's launch as the profiler's trace recorded it:
    {name: {"grid": [x, y, z], "block": [x, y, z], "registers": n}}, the
    registers a thread; raises if the calls launched a kernel in more than
    one shape."""
    events = trace_events(prof)
    shapes = {}
    for name in kernel_names:
        seen = {
            (tuple(e["args"]["grid"]), tuple(e["args"]["block"]), e["args"]["registers per thread"])
            for e in events if e.get("cat") == "kernel" and name in e.get("name", "")
        }
        if len(seen) != 1:
            raise AssertionError(f"profiler trace: {name} launched in {len(seen)} shapes: {sorted(seen)}")
        grid, block, regs = seen.pop()
        shapes[name] = {"grid": list(grid), "block": list(block), "registers": regs}
    return shapes


def stamp(device: torch.device):
    """A point in time on `device`: a CUDA event recorded on the current
    stream, or the host clock on the CPU (whose ops finish before they
    return)."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def elapsed_ms(start, end) -> float:
    """Milliseconds between two stamps; on the card, call after a
    synchronise that follows `end`."""
    if isinstance(start, float):
        return (end - start) * 1e3
    return start.elapsed_time(end)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def back_to_back_ms(step: Callable[[Tensor], Tensor], n: int, device: torch.device, warm: int = 1) -> float:
    """Milliseconds a call of `step` over `n` calls back to back: the
    counterpart of the JAX scripts' in-jit scan (bench.py:145-158).
    `step(carry)` takes a 0-d f32 tensor, adds it to its input (bench.py:
    148-150) and returns a small multiple of its output, so no call can
    reuse another's result. After `warm` calls the n calls run between two
    stamps with one synchronise, after the last: the device's throughput,
    not the latency of one call."""
    carry = torch.zeros((), device=device)
    for _ in range(warm):
        carry = step(carry)
    synchronize(device)
    start = stamp(device)
    for _ in range(n):
        carry = step(carry)
    end = stamp(device)
    synchronize(device)
    if not bool(torch.isfinite(carry)):
        raise AssertionError(f"back_to_back_ms: the carry is {float(carry)}")
    return elapsed_ms(start, end) / n


def trace_breakdown(events: Sequence[dict], calls: int, top: int = 10) -> Dict[str, object]:
    """Where the device's time went in a chrome trace of `calls` calls:
    device time a call (the union of the kernels' intervals), the window a
    call (first to last event of any host op or kernel), the busy share of
    it, the kernels a call, the `top` kernels by device time, and the `top`
    longest gaps between kernels, each named by the innermost host op
    (`cpu_op`) running at its midpoint (None where none was). Times in ms."""
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("ph") == "X" and e.get("cat") == "kernel")
    ops = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    if not kernels:
        raise AssertionError("trace_breakdown: the trace holds no kernel")
    spans = kernels + ops
    window = max(end for _, end, _ in spans) - min(start for start, _, _ in spans)
    busy = []  # the kernels' intervals, merged
    for start, end, _ in kernels:
        if busy and start <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], end)
        else:
            busy.append([start, end])
    device = sum(end - start for start, end in busy)
    by_name: Dict[str, List[float]] = {}
    for start, end, name in kernels:
        by_name.setdefault(name, []).append(end - start)

    def host_op(t):
        covering = [(end - start, name) for start, end, name in ops if start <= t <= end]
        return min(covering)[1] if covering else None

    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])), key=lambda g: -g[0])[:top]
    return {
        "device_ms": device / calls / 1e3,
        "window_ms": window / calls / 1e3,
        "busy_share": device / window,
        "kernels_per_call": len(kernels) / calls,
        "top_kernels": [
            {"name": name, "ms_per_call": sum(d) / calls / 1e3, "launches_per_call": len(d) / calls}
            for name, d in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]
        ],
        "gaps": [{"ms": gap / 1e3, "host_op": host_op((start + end) / 2)} for gap, start, end in gaps],
    }


def device_breakdown(fn: Callable[[], object], reps: int, top: int = 10) -> Optional[Dict[str, object]]:
    """trace_breakdown of `reps` calls of `fn` under torch.profiler (host
    ops and kernels), after one call outside it; None on a machine without
    CUDA, where there is no device time to read."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return trace_breakdown(trace_events(prof), reps, top)


def host_syncs(fn: Callable[[], object]) -> Optional[Dict[str, object]]:
    """The synchronisations of the host with the card in one call of `fn`,
    as torch.cuda.set_sync_debug_mode("warn") reports them: their count and
    the Python lines that made them (file:line, most frequent first). None
    on a machine without CUDA."""
    if not torch.cuda.is_available():
        return None
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    hits = [w for w in caught if "synchroniz" in str(w.message)]

    def where(w):
        path = Path(w.filename)
        return f"{path.relative_to(ROOT) if path.is_relative_to(ROOT) else '/'.join(path.parts[-2:])}:{w.lineno}"

    return {"count": len(hits), "where": dict(Counter(where(w) for w in hits).most_common())}
