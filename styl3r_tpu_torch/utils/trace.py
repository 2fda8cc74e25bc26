"""Spans and counters of the program's layers, on the device's clock and in
the profiler's trace.

    from styl3r_tpu_torch.utils import trace

    with trace.span("backbone"):
        ...

A span does nothing but test a flag unless tracing is active: while a
torch profiler runs, or inside `with trace.enabled():`. Active, it opens a
`torch.profiler.record_function("styl3r/<name>")` range, so the span sits
in any profiler trace on the kernels' clock, and records a CUDA event on
the current stream at each end (the host clock where CUDA is not in use).
The events are resolved when the totals are read, never inside a span, so
a span adds no kernel and no synchronisation. While the current stream is
being captured into a CUDA graph a span records no event.

`count(name, n)` adds to an integer counter that is always on: the kernel
launches, one counter a kernel of utils/cuda_build.py, and the Styl3r
encoder's calls, CUDA-graph captures and replays. Reads
(`totals`, `counters`, `drain`) may synchronise; they are for after the
work. Every span and counter name is declared below; recording another is
an error.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch
from torch.autograd import profiler as _profiler

from .cuda_build import KERNELS

PREFIX = "styl3r/"

SPANS = (
    "encoder",  # Styl3rModel.predict_gaussians
    "backbone",  # the encoder's CroCo backbone
    "stylizer",  # the encoder's token stylizer
    "heads",  # a group of the encoder's DPT heads (pts3d; gs and appearance)
    "adapter",  # the Gaussian adapter (encoder.py::_adapt)
    "rope",  # RoPE2D on an attention's q and k
    "render",  # decoder.py::render_gaussians
    "sort",  # the renderer's binning, sort and tile ranges
    "pack",  # the renderer's gather of the sorted pairs' attributes
    "forward",  # a train step from its batch to its scalar loss
    "teacher",  # the distillation teacher's forward
    "loss",  # a train step's loss_fn
    "backward",  # a train step's loss.backward()
    "clip",  # GroupedAdamW.step: zero-fill and the clip by the global norm
    "adamw",  # GroupedAdamW.step: AdamW and the schedule
    "allreduce",  # the data-parallel all-reduce of the gradients
    "step",  # the Trainer's call of the step function
    "patch_embed",  # VGGT's DINOv2 patch embedding (models/vggt.py)
    "frame_blocks",  # one of VGGT's frame-attention blocks
    "global_blocks",  # one of VGGT's global-attention blocks
    "camera_head",  # VGGT's camera head, its refinements together
)

# Launches of each csrc/<name>.cu's kernels, by name, as cuda_build.launch
# counts them (a replayed CUDA graph counts the launches it holds); then
# models/encoder.py's Styl3rEncoder.forward calls on a CUDA device, and
# those of them that captured its CUDA graphs and that replayed them.
COUNTERS = tuple(KERNELS) + ("encoder_calls", "encoder_captures", "encoder_replays")

_depth = 0  # open enabled() scopes
_pending: Dict[str, List[tuple]] = {}  # closed spans whose stamps are not yet read
_totals: Dict[str, List[float]] = {}  # name -> [ms, entries]
_counts: Dict[str, int] = dict.fromkeys(COUNTERS, 0)


def active() -> bool:
    """Whether spans record: a profiler runs, or an enabled() scope is open."""
    return _depth > 0 or _profiler._is_profiler_enabled


@contextlib.contextmanager
def enabled():
    """Turns tracing on inside the scope (scopes nest)."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stamp(cuda: bool):
    if not cuda:
        return time.perf_counter()
    if torch.cuda.is_current_stream_capturing():
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class _Span:
    __slots__ = ("name", "cuda", "range", "start")

    def __init__(self, name: str):
        if name not in SPANS:
            raise ValueError(f"trace.span: {name!r} is not a declared span (utils/trace.py::SPANS)")
        self.name = name
        self.cuda = torch.cuda.is_initialized()

    def __enter__(self):
        self.range = _profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.start = _stamp(self.cuda)
        return None

    def __exit__(self, *exc):
        end = _stamp(self.cuda)
        if self.start is not None and end is not None:
            _pending.setdefault(self.name, []).append((self.start, end))
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager timing the layer `name` (one of SPANS) when
    tracing is active, and nothing else when it is not."""
    return _Span(name) if active() else _OFF


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name` (one of COUNTERS)."""
    if name not in _counts:
        raise ValueError(f"trace.count: {name!r} is not a declared counter (utils/trace.py::COUNTERS)")
    _counts[name] += n


def _resolve() -> None:
    for name, marks in _pending.items():
        total = _totals.setdefault(name, [0.0, 0])
        for start, end in marks:
            if isinstance(start, float):
                total[0] += 1e3 * (end - start)
            else:
                end.synchronize()
                total[0] += start.elapsed_time(end)
            total[1] += 1
    _pending.clear()


def totals() -> Dict[str, Tuple[float, int]]:
    """{span: (milliseconds, entries)} since the last drain or reset, summed
    over every entry (nested entries of one name count each)."""
    _resolve()
    return {name: (ms, n) for name, (ms, n) in _totals.items()}


def counters() -> Dict[str, int]:
    """The counters' values since the last reset."""
    return dict(_counts)


def drain() -> Dict[str, Tuple[float, int]]:
    """totals(), then clears them (the counters stay)."""
    out = totals()
    _totals.clear()
    return out


def reset() -> None:
    """Clears the totals, spans not yet read and the counters."""
    _pending.clear()
    _totals.clear()
    for name in _counts:
        _counts[name] = 0
