"""Evaluation: metrics, timers and the test-step harness (counterpart of
styl3r_tpu/eval/)."""

from .benchmarker import Benchmarker
from .metrics import MetricTracker, compute_psnr, compute_ssim

__all__ = ["compute_psnr", "compute_ssim", "MetricTracker", "Benchmarker"]
