"""Full Styl3R model: unposed context + style image -> Gaussians -> renders
(counterpart of styl3r_tpu/models/styl3r.py).

The JAX model is a bundle of pure functions over a params tree; here it is
an `nn.Module` holding the encoder under `encoder.`, so `state_dict()` has
the reference's Lightning key names (`encoder.backbone.enc_blocks.0...`).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch import Tensor

from ..device import DeviceLike, resolve_device
from ..utils import trace
from ..utils.convert import init_like_flax_
from .decoder import render_gaussians
from .encoder import Styl3rEncoder


class Batch(NamedTuple):
    """One inference batch (leading dims (b, v) or (b,)), in the JAX layouts."""

    context_images: Tensor  # (b, v, h, w, 3) in [0, 1]
    context_intrinsics: Tensor  # (b, v, 3, 3) normalized
    target_extrinsics: Tensor  # (b, t, 4, 4) c2w, context-0-relative
    target_intrinsics: Tensor  # (b, t, 3, 3)
    target_near: Tensor  # (b, t)
    target_far: Tensor  # (b, t)
    style_image: Tensor  # (b, hs, ws, 3) in [0, 1]
    target_images: Optional[Tensor] = None  # (b, t, h, w, 3) in [0, 1]
    sparse_anchor: Optional[Any] = None


def batch_to(batch, device: DeviceLike) -> Batch:
    """Any Batch-shaped tuple of numpy arrays or tensors -> a Batch of f32
    tensors on `device` (sparse_anchor passes through)."""
    out = [
        None if x is None
        else x.to(device, torch.float32) if torch.is_tensor(x)
        else torch.as_tensor(np.array(x, np.float32), device=device)
        for x in batch[:8]
    ]
    return Batch(*out, sparse_anchor=batch[8] if len(batch) > 8 else None)


def normalize_images(images: Tensor) -> Tensor:
    """[0, 1] -> [-1, 1]."""
    return images * 2.0 - 1.0


def transpose_intrinsics(k: Tensor) -> Tensor:
    """Normalized intrinsics of the h/w-transposed image: fx/cx swap with
    fy/cy."""
    out = k.clone()
    out[..., 0, 0], out[..., 1, 1] = k[..., 1, 1], k[..., 0, 0]
    out[..., 0, 2], out[..., 1, 2] = k[..., 1, 2], k[..., 0, 2]
    return out


class Styl3rModel(nn.Module):
    """Encoder + splatting decoder.

    Weights are drawn in f32 on `device` the way flax's defaults draw them,
    from a torch.Generator seeded with `seed`, and stay f32: `backbone_dtype`
    and `head_trunk_dtype` are compute dtypes, as in flax. Serving may store
    the backbone/stylizer and DPT trunks in those dtypes with
    `cast_dtypes()`. Load real weights with `load_state_dict` (see
    utils/convert.py::from_jax_params).

    The model starts in eval mode; training calls `.train()`, which turns on
    the gs towers' dropout, drawn from the `generator` the forward is
    given."""

    def __init__(
        self,
        sh_degree: int = 0,
        backbone_dtype: torch.dtype = torch.float32,
        device: DeviceLike = None,
        seed: int = 0,
        **encoder_kwargs,
    ):
        super().__init__()
        self.device = resolve_device(device)
        with self.device:
            self.encoder = Styl3rEncoder(
                sh_degree=sh_degree, backbone_dtype=backbone_dtype, **encoder_kwargs
            )
        generator = torch.Generator(self.device).manual_seed(seed)
        init_like_flax_(self.encoder, generator)
        self.eval()

    def cast_dtypes(self) -> "Styl3rModel":
        """For serving: store the backbone/stylizer and DPT trunks in their
        compute dtypes, as bench.py does. A model that trains keeps f32."""
        self.encoder.cast_dtypes()
        return self

    def predict_gaussians(
        self,
        batch: Batch,
        global_step: int = 0,
        return_aux: bool = False,
        portrait: bool = False,
        generator: Optional[torch.Generator] = None,
        distill_only: bool = False,
    ):
        """With `portrait` (whole-batch portrait scenes, h > w) the encoder
        runs on the transposed inputs with swapped intrinsics and its dense
        maps transpose back before the adapter. `generator` feeds dropout in
        training mode. With `distill_only` the encoder stops at its point
        maps: {"pts3d", "depths"}."""
        context = normalize_images(batch.context_images)
        style = normalize_images(batch.style_image)
        intrinsics = batch.context_intrinsics
        if portrait:
            context = context.transpose(2, 3)
            style = style.transpose(1, 2)
            intrinsics = transpose_intrinsics(intrinsics)
        with trace.span("encoder"):
            return self.encoder(
                context, intrinsics, style,
                global_step=global_step, return_aux=return_aux, transpose_maps=portrait,
                generator=generator, distill_only=distill_only,
            )

    def forward(
        self,
        batch: Batch,
        image_shape: Tuple[int, int],
        global_step: int = 0,
        return_aux: bool = False,
        portrait: bool = False,
        generator: Optional[torch.Generator] = None,
        **render_kwargs,
    ):
        """Predict + render into the batch's target cameras. Returns
        (gaussians, DecoderOutput), plus the encoder's aux dict with
        return_aux."""
        out = self.predict_gaussians(
            batch, global_step, return_aux=return_aux, portrait=portrait, generator=generator
        )
        gaussians, aux = out if return_aux else (out, None)
        output = render_gaussians(
            gaussians,
            batch.target_extrinsics,
            batch.target_intrinsics,
            batch.target_near,
            batch.target_far,
            image_shape,
            **render_kwargs,
        )
        if return_aux:
            return gaussians, output, aux
        return gaussians, output
