"""The program's own spans (styl3r_tpu_torch/utils/trace.py), as the
per-layer readers read them. The tracer is active only while a profiler
runs, so what it holds at the end of a run is the driver's profiled slice
alone: the warm-up, the window, the host-sync count and the reference
leave it empty. A span's CUDA events are resolved here, after the run."""

from __future__ import annotations

from typing import Optional


def span_ms(record: dict, name: str) -> Optional[float]:
    """The span's total milliseconds in the profiled slice over the slice's
    calls (`trace_calls`: requests, forwards or steps); None where the
    record has no profiled slice, the program has no tracer, or the span
    never ran."""
    calls = record.get("trace_calls")
    if not calls:
        return None
    try:
        from styl3r_tpu_torch.utils import trace
    except ImportError:
        return None
    ms, entries = trace.totals().get(name, (0.0, 0))
    return ms / calls if entries else None
