"""Simple pixel losses (counterpart of styl3r_tpu/losses/basic.py)."""

from __future__ import annotations

from torch import Tensor


def mse_loss(pred: Tensor, target: Tensor, weight: float = 1.0) -> Tensor:
    return weight * ((pred - target) ** 2).mean()
