"""The reference Styl3R model: context views + style image -> Gaussians ->
renders, in float32 (frozen copy of styl3r_tpu_torch/models/styl3r.py's
predict and render, without portrait mode or a dropout generator). Its
state-dict keys are the program's (`encoder.backbone.enc_blocks.0...`)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
from torch import Tensor

from .decoder import render_gaussians
from .encoder import Styl3rEncoder


class Batch(NamedTuple):
    context_images: Tensor  # (b, v, h, w, 3) in [0, 1]
    context_intrinsics: Tensor  # (b, v, 3, 3) normalized
    target_extrinsics: Tensor  # (b, t, 4, 4) c2w, context-0-relative
    target_intrinsics: Tensor  # (b, t, 3, 3)
    target_near: Tensor  # (b, t)
    target_far: Tensor  # (b, t)
    style_image: Tensor  # (b, hs, ws, 3) in [0, 1]
    target_images: Optional[Tensor] = None  # (b, t, h, w, 3) in [0, 1]


def batch_on(arrays, device) -> Batch:
    """A Batch of f32 tensors on `device` from numpy arrays or tensors."""
    return Batch(*(None if x is None else torch.as_tensor(x).to(device, torch.float32) for x in arrays[:8]))


def normalize_images(images: Tensor) -> Tensor:
    return images * 2.0 - 1.0


class Styl3rRef(nn.Module):
    def __init__(self, sh_degree: int = 0, **widths):
        super().__init__()
        self.encoder = Styl3rEncoder(sh_degree=sh_degree, **widths)

    def predict_gaussians(self, batch: Batch, global_step: int = 0, distill_only: bool = False,
                          generator: Optional[torch.Generator] = None):
        return self.encoder(
            normalize_images(batch.context_images), batch.context_intrinsics,
            normalize_images(batch.style_image), global_step=global_step, distill_only=distill_only,
            generator=generator,
        )

    def forward(self, batch: Batch, image_shape: Tuple[int, int], generator: Optional[torch.Generator] = None,
                **render_kwargs):
        gaussians = self.predict_gaussians(batch, generator=generator)
        out = render_gaussians(
            gaussians, batch.target_extrinsics, batch.target_intrinsics, batch.target_near,
            batch.target_far, image_shape, **render_kwargs,
        )
        return gaussians, out
