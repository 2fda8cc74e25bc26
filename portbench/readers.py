"""Arithmetic the per-layer metric readers share (portbench/metrics/*.py).
Each reader takes the record a driver filled and returns its number, or
None where the record holds nothing for it; the harness then leaves the
metric out of the result."""

from __future__ import annotations

import sys
from typing import Optional

from .core import BF16_PEAK_FLOPS, median


def span_median(record: dict, name: str) -> Optional[float]:
    spans = record.get("spans_ms", {}).get(name)
    return median(spans) if spans else None


def idle_share(record: dict) -> Optional[float]:
    trace = record.get("trace")
    return None if trace is None else 100.0 * (1.0 - trace["busy_share"])


def mfu(record: dict) -> Optional[float]:
    """The counted FLOPs of the window's calls over its seconds, as a share
    of the card's dense bf16 peak, in %."""
    if not record.get("calls") or not record.get("flops_per_call"):
        return None
    return 100.0 * record["flops_per_call"] * record["calls"] / record["window_s"] / BF16_PEAK_FLOPS


def kernel_roofline(record: dict, kernel, inputs_key: str, bound) -> Optional[float]:
    """The share of its roofline that `kernel` (a name, or names whose
    launches make one call) reached in the profiled slice, in %: the bounds
    of the calls the slice captured (`bound(args)` of each) over the
    profiler's device time of the kernels' launches in the slice."""
    trace, calls = record.get("trace"), record.get(inputs_key)
    if trace is None or not calls:
        return None
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)

    def ours(name):
        return any(k in name for k in names)

    seconds = sum(t for name, t in trace["kernel_seconds"].items() if ours(name))
    if seconds <= 0:
        return None
    bounds = [bound(args) for args in calls]
    kinds = sorted({kind for _, kind in bounds})
    print(f"{'+'.join(names)}: bound by {' and '.join(kinds)}; {len(calls)} calls, "
          f"{sum(n for name, n in trace['kernel_launches'].items() if ours(name))} launches seen", file=sys.stderr)
    return 100.0 * sum(b for b, _ in bounds) / seconds
