"""Image quality metrics and running means per context-overlap bucket
(counterpart of styl3r_tpu/eval/metrics.py; reference
`src/evaluation/metrics.py:11-53`, `model_wrapper_style.py:793-841`)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import torch
from torch import Tensor

from ..losses.ssim import ssim


def compute_psnr(ground_truth: Tensor, predicted: Tensor) -> Tensor:
    """PSNR of each image of (..., h, w, c) in [0, 1]."""
    gt = torch.clamp(ground_truth, 0.0, 1.0)
    pred = torch.clamp(predicted, 0.0, 1.0)
    mse = ((gt - pred) ** 2).mean(dim=(-1, -2, -3))
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def compute_ssim(ground_truth: Tensor, predicted: Tensor) -> Tensor:
    """SSIM of each image of (n, h, w, c) (or of one (h, w, c) image)."""
    return ssim(torch.clamp(ground_truth, 0, 1), torch.clamp(predicted, 0, 1))


def overlap_tag(overlap: float) -> str:
    """The reference's context-overlap bucket (`misc/utils.py:38-48`)."""
    if overlap < 0.3:
        return "small"
    if overlap <= 0.55:
        return "medium"
    return "large"


class MetricTracker:
    """Running means per (metric, bucket) and overall; prints a table."""

    def __init__(self):
        self.sums: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def update(self, metrics: Dict[str, float], overlap: Optional[float] = None):
        buckets = ["all"]
        if overlap is not None:
            buckets.append(overlap_tag(overlap))
        for name, value in metrics.items():
            for b in buckets:
                key = f"{name}/{b}"
                self.sums[key] += float(value)
                self.counts[key] += 1

    def means(self) -> Dict[str, float]:
        return {k: self.sums[k] / self.counts[k] for k in self.sums}

    def table(self) -> str:
        means = self.means()
        names = sorted({k.split("/")[0] for k in means})
        buckets = ["all", "small", "medium", "large"]
        lines = ["metric    " + "".join(f"{b:>10}" for b in buckets)]
        for n in names:
            row = f"{n:<10}"
            for b in buckets:
                v = means.get(f"{n}/{b}")
                row += f"{v:>10.4f}" if v is not None else f"{'-':>10}"
            lines.append(row)
        return "\n".join(lines)
