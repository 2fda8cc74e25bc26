"""What the drivers share: the run's context, the weights, spans, the
profiled slice, and the comparison's arithmetic."""

from __future__ import annotations

import contextlib
import gc
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .reference.init import drawn
from .timing import trace_breakdown, trace_events

BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet, 700 W)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class Context:
    """One run: its cell, seed, window, whether it is traced, the device,
    the configuration and workload files, and when set-up began."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: dict
    workload: dict
    t_start: float
    setup_s: Optional[float] = None
    log: Callable[[str], None] = print

    def setup_done(self) -> None:
        """Set-up ends here: the device has finished, and what set-up left
        on the heap is moved out of the collector's way (gc.freeze), so a
        collection inside the window walks only the window's objects."""
        synchronize(self.device)
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - self.t_start


@dataclass
class Outcome:
    """What a driver hands back: requests or steps attempted and failed,
    its end-to-end readings, the record the per-layer readers read, the
    device's peak over the window, and the numbers compared with their
    limits (name -> (value, limit))."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    record: Dict[str, object]
    memory_peak_bytes: int
    checks: Dict[str, tuple] = field(default_factory=dict)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def widths(config: dict) -> dict:
    w = dict(config["widths"])
    w["head_layer_dims"] = tuple(w["head_layer_dims"])
    return w


def reference_weights(make, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The state dict of the reference module `make()` drawn from `seed` on
    `device`: what the program loads by key name."""
    return drawn(make, seed, device).state_dict()


class Spans:
    """Named spans on the device's clock: CUDA events around each call
    (read after the run has synchronised), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: Dict[str, List[tuple]] = {}
        self._open: Dict[str, object] = {}

    def _stamp(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def start(self, name: str) -> None:
        self._open[name] = self._stamp()

    def stop(self, name: str) -> None:
        self.marks.setdefault(name, []).append((self._open.pop(name), self._stamp()))

    @contextlib.contextmanager
    def span(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def wrap(self, name: str, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped

    def ms(self) -> Dict[str, List[float]]:
        def one(a, b):
            return a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        if self.cuda:
            torch.cuda.synchronize()
        return {name: [one(a, b) for a, b in marks] for name, marks in self.marks.items()}


def profiled(fn: Callable[[], object], calls: int) -> Dict[str, object]:
    """trace_breakdown of `calls` calls of `fn` under torch.profiler, host
    ops and kernels; the chrome trace goes under TMPDIR and is deleted."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = trace_events(prof)
    del prof
    return trace_breakdown(events, calls)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in float64 over the whole tensor (b the reference)."""
    if a.shape != b.shape:
        return math.inf
    a, b = a.double().cpu(), b.double().cpu()
    den = float(b.norm())
    return float((a - b).norm()) / den if den > 0 else (0.0 if float(a.norm()) == 0 else math.inf)


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float], ref_grad: Dict[str, float]) -> tuple:
    """The largest gap between two per-leaf norms, |p - r| / max(r, the
    median leaf's r), over the leaves whose reference gradient norm is at
    least a thousandth of the median leaf's (the others move by round-off
    alone). Returns (gap, the leaf it is at, leaves compared)."""
    med_g = median(ref_grad.values())
    keep = [k for k in reference if ref_grad[k] >= 1e-3 * med_g]
    med = median(reference[k] for k in keep)
    worst, at = 0.0, None
    for k in keep:
        gap = abs(program[k] - reference[k]) / max(reference[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k, len(keep)
        if gap > worst:
            worst, at = gap, k
    return worst, at, len(keep)


def median(values) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def limits_checks(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, tuple]:
    """(value, limit) of every number the workload file holds a limit for."""
    return {name: (values[name], limit) for name, limit in limits.items()}


def pick(seed: int, count: int, among: int) -> List[int]:
    """`count` distinct indices below `among`, drawn from the seed."""
    g = torch.Generator().manual_seed(int(seed) % (2**63))
    return sorted(torch.randperm(among, generator=g)[:count].tolist())


def quantile(values: Sequence[float], q: float) -> float:
    """The q-quantile of `values` by linear interpolation (numpy's default)."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
