"""Depth smoothness loss (counterpart of styl3r_tpu/losses/depth.py;
reference `src/loss/loss_depth.py:26-59`, off in every release config):
rendered-depth gradients penalized, optionally down-weighted at image edges
(bilateral weighting)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


def depth_smoothness_loss(
    depth: Tensor,  # (..., h, w)
    image: Optional[Tensor] = None,  # (..., h, w, 3), for the bilateral weight
    weight: float = 1.0,
    sigma: float = 10.0,
) -> Tensor:
    dzdx = (depth[..., :, 1:] - depth[..., :, :-1]).abs()
    dzdy = (depth[..., 1:, :] - depth[..., :-1, :]).abs()
    if image is not None:
        didx = (image[..., :, 1:, :] - image[..., :, :-1, :]).abs().mean(dim=-1)
        didy = (image[..., 1:, :, :] - image[..., :-1, :, :]).abs().mean(dim=-1)
        dzdx = dzdx * torch.exp(-sigma * didx)
        dzdy = dzdy * torch.exp(-sigma * didy)
    return weight * (dzdx.mean() + dzdy.mean())
