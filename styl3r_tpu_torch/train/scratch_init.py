"""Head initialization for training without a MASt3R warm start
(counterpart of styl3r_tpu/train/scratch_init.py, which explains the why).

A freshly drawn model puts every Gaussian mean near the camera origin
(expm1 of a raw norm near 0) with sub-pixel scales, so renders come out
empty and the render's gradient is (nearly) zero. `scratch_init_heads`
rewrites only the final conv of each pts3d and structure head: its bias sets
the raw prediction's regime, and its kernel is damped so the random spread
does not swamp the bias through expm1."""

from __future__ import annotations

import math

import torch

__all__ = ["scratch_init_heads"]


def _softplus_inv(y: float) -> float:
    return math.log(math.expm1(y))


@torch.no_grad()
def scratch_init_heads(model, depth0: float = 1.0, scale0: float = 0.01, kernel_damp: float = 0.1):
    """In place on a Styl3rModel (or its encoder); returns it.

    pts3d heads (downstream_head1/2, final conv `dpt.head.4`): bias
    (0, 0, log1p(depth0)) puts the points at z ~ depth0. Structure heads
    (gaussian_param_head/2, `dpt.head.4`, channels [opacity, 3 scale,
    4 quat]): scale bias softplus^-1(scale0 / 0.001), quaternion bias the
    identity (x, y, z, w = 0, 0, 0, 1). Each final kernel is scaled by
    kernel_damp."""
    encoder = getattr(model, "encoder", model)
    pts_bias = [0.0, 0.0, math.log1p(depth0)]
    gs_bias = [0.0] + [_softplus_inv(scale0 / 0.001)] * 3 + [0.0, 0.0, 0.0, 1.0]
    for name, bias in (
        ("downstream_head1", pts_bias), ("downstream_head2", pts_bias),
        ("gaussian_param_head", gs_bias), ("gaussian_param_head2", gs_bias),
    ):
        conv = getattr(encoder, name).dpt.head["4"]
        conv.bias.copy_(torch.tensor(bias, dtype=conv.bias.dtype))
        conv.weight.mul_(kernel_damp)
    return model
