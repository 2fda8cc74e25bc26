"""Timers accumulated per tag, dumped to JSON, and peak device memory
(counterpart of styl3r_tpu/eval/benchmarker.py; reference
`src/misc/benchmarker.py:12-45`).

On a CUDA device a timed block lies between two CUDA events on the current
stream, read after a synchronize, so it ends when the device has done the
block's work; on the CPU the block is timed with perf_counter.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List

import torch

from ..device import DeviceLike


class Benchmarker:
    """Timers on the clock of `device`, the device whose work the timed
    blocks launch (no default: a CUDA run timed on the host's clock would
    measure the enqueue)."""

    def __init__(self, device: DeviceLike):
        self.device = torch.device(device)
        self.execution_times: Dict[str, List[float]] = defaultdict(list)
        self._group_sizes: Dict[str, List[int]] = defaultdict(list)
        self.last_elapsed = 0.0

    @contextmanager
    def time(self, tag: str, num_calls: int = 1):
        """Time a block, in seconds, and record it under `tag` split over
        `num_calls` (a block that renders t frames counts t calls)."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            elapsed = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            yield
            elapsed = time.perf_counter() - t0
        self.last_elapsed = elapsed
        self.record(tag, elapsed, num_calls)

    def record(self, tag: str, elapsed: float, num_calls: int = 1) -> None:
        """Append a measured block under `tag`, split over `num_calls`, so
        one block can feed several per-frame divisors."""
        for _ in range(num_calls):
            self.execution_times[tag].append(elapsed / num_calls)
        self._group_sizes[tag].append(num_calls)

    def summarize(self) -> Dict[str, float]:
        """Each tag's mean (the reference's contract) and `<tag>_steady`,
        the mean without the tag's first block, which pays first-call costs
        (cuDNN autotuning, allocator growth, the kernels' build)."""
        out = {}
        for tag, times in self.execution_times.items():
            out[tag] = sum(times) / len(times)
            steady = times[self._group_sizes[tag][0]:]
            if steady:
                out[f"{tag}_steady"] = sum(steady) / len(steady)
        return out

    def dump(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        with path.open("w") as f:
            json.dump(self.summarize(), f, indent=2)

    def dump_memory(self, path: Path) -> None:
        """Peak bytes allocated on the device since the process started (or
        since torch.cuda.reset_peak_memory_stats); null on the CPU."""
        if self.device.type == "cuda":
            stats = {torch.cuda.get_device_name(self.device): torch.cuda.max_memory_allocated(self.device)}
        else:
            stats = {"cpu": None}
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        with path.open("w") as f:
            json.dump(stats, f, indent=2)
