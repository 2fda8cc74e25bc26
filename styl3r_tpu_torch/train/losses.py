"""Training loss bundle (counterpart of styl3r_tpu/train/losses.py; the
reference's loss registry and `model_wrapper_style.py:189-242`): MSE, LPIPS
after a warm-up step, the VGG style loss and the identity branch, plus the
scratch-training regularizers."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch import Tensor

from ..losses.basic import mse_loss
from ..losses.style import identity_loss, style_loss


@dataclass
class LossBundle:
    """Configured losses and the frozen perceptual nets (VGG19Features for
    style/identity, LPIPSVgg16 for LPIPS) they need."""

    mse_weight: Optional[float] = 1.0
    lpips_weight: Optional[float] = None
    lpips_apply_after_step: int = 0
    style_weight: Optional[float] = None  # style-stats weight (reference: 10)
    identity: bool = False
    identity_weight_pixel: float = 70.0
    identity_weight_feat: float = 1.0
    vgg19: Optional[nn.Module] = None
    lpips: Optional[nn.Module] = None

    def _vgg(self) -> nn.Module:
        if self.vgg19 is None:
            raise ValueError("style/identity loss requires vgg19")
        return self.vgg19

    def __call__(
        self, output, batch, gaussians, global_step: int = 0, identity_output=None
    ) -> Tuple[Tensor, Dict[str, Tensor]]:
        target = batch.target_images
        total = torch.zeros((), device=target.device)
        metrics: Dict[str, Tensor] = {}

        if self.mse_weight:
            l = mse_loss(output.color, target, self.mse_weight)
            total, metrics["mse"] = total + l, l

        if self.lpips_weight and self.lpips is not None:
            if global_step >= self.lpips_apply_after_step:
                b, v = target.shape[:2]
                l = self.lpips_weight * self.lpips(
                    output.color.reshape(b * v, *output.color.shape[2:]),
                    target.reshape(b * v, *target.shape[2:]),
                ).mean()
            else:  # gated off: zero, as the reference's step gate gives
                l = torch.zeros((), device=target.device)
            total, metrics["lpips"] = total + l, l

        if self.style_weight:
            l, style_metrics = style_loss(
                self._vgg(), output.color, target, batch.style_image, self.style_weight
            )
            total = total + l
            metrics["style"] = l
            metrics.update(style_metrics)

        if self.identity and identity_output is not None:
            l = identity_loss(
                self._vgg(), identity_output.color, target,
                self.identity_weight_pixel, self.identity_weight_feat,
            )
            total, metrics["identity"] = total + l, l

        return total, metrics


def scratch_stabilizer(
    gaussians,
    z_min: float = 0.3,
    z_weight: float = 0.1,
    opacity_floor: float = 0.15,
    opacity_weight: float = 0.5,
    dist_ceil: float = 6.0,
    dist_weight: float = 0.05,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Anti-collapse regularizer for training without a MASt3R warm start
    (see the JAX package's docstring): a z-hinge in front of the context-0
    camera, a floor on the mean opacity and a ceiling on the distance. All
    terms are exactly zero in a healthy regime."""
    z = gaussians.means[..., 2]
    z_pen = z_weight * torch.relu(z_min - z).mean()
    op_pen = opacity_weight * torch.relu(opacity_floor - gaussians.opacities.mean())
    dist = torch.linalg.norm(gaussians.means, dim=-1)
    dist_pen = dist_weight * torch.relu(dist - dist_ceil).mean()
    total = z_pen + op_pen + dist_pen
    return total, {"stab_z": z_pen, "stab_opacity": op_pen, "stab_dist": dist_pen}


def sparse_anchor_loss(gaussians, anchor: Dict[str, Tensor], delta: float = 1.0) -> Tensor:
    """Huber loss pulling the Gaussians predicted at COLMAP-tracked pixels to
    those points (scratch training). anchor: flat_idx (b, k) int into the
    flattened v*h*w Gaussian axis, target (b, k, 3) in the context-0 frame,
    mask (b, k) float validity."""
    idx = anchor["flat_idx"].long()[..., None].expand(*anchor["flat_idx"].shape, 3)
    err = torch.gather(gaussians.means, 1, idx) - anchor["target"]
    abs_err = err.abs()
    huber = torch.where(abs_err <= delta, 0.5 * err * err / delta, abs_err - 0.5 * delta).sum(-1)
    mask = anchor["mask"]
    return (huber * mask).sum() / torch.clamp(mask.sum(), min=1.0)
