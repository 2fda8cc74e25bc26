"""Profiler readings (frozen copy of styl3r_tpu_torch/bench/timing.py's
trace_breakdown, trace_events and host_syncs)."""

from __future__ import annotations

import json
import os
import tempfile
import warnings
from collections import Counter
from pathlib import Path
from typing import Dict, List, Sequence

import torch

ROOT = Path(__file__).resolve().parents[1]
NAME_CHARS = 160  # a kernel's name in the breakdown is cut to this many characters


def trace_events(prof) -> List[dict]:
    """The chrome trace's event list of a finished torch.profiler window,
    written under TMPDIR and deleted at once."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def trace_breakdown(events: Sequence[dict], calls: int, top: int = 10) -> Dict[str, object]:
    """Where the device's time went in a chrome trace of `calls` calls: the
    device's busy time (the union of the kernels' intervals) and the window
    (first to last event of any host op or kernel), in seconds over the
    whole trace; the busy share; kernels a call; the `top` kernels by device
    time; the `top` longest gaps between kernels, each named by the
    innermost host op running at its midpoint (None where none was)."""
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
    ops.sort()

    def host_op(t):
        covering = [(end - start, name) for start, end, name in ops if start <= t <= end]
        return min(covering)[1] if covering else "none"

    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])), key=lambda g: -g[0])[:top]
    return {
        "busy_s": device / 1e6,
        "window_s": window / 1e6,
        "busy_share": device / window,
        "kernels": len(kernels),
        "kernels_per_call": len(kernels) / calls,
        "kernel_seconds": {name: sum(d) / 1e6 for name, d in by_name.items()},
        "kernel_launches": {name: len(d) for name, d in by_name.items()},
        "device_ops": [[name[:NAME_CHARS], sum(d) / 1e6]
                       for name, d in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]],
        "idle_gaps": [[host_op((start + end) / 2), gap / 1e6] for gap, start, end in gaps],
    }


def host_syncs(fn) -> Dict[str, object]:
    """The synchronisations of the host with the card in one call of `fn`,
    as torch.cuda.set_sync_debug_mode("warn") reports them: their count and
    the lines that made them, most frequent first."""
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
