"""The control: the reference one precision step below what a
configuration states. Where it states bfloat16 compute, every linear and
convolution of those modules rounds its input and its weight to fp8
(e4m3, one scale a tensor, from the tensor's largest magnitude) and
multiplies the rounded values; where it states float32 with TF32 off,
matmuls and convolutions run in TF32; the compositor, whose float32 is
elementwise arithmetic, composites bfloat16-rounded pair attributes. A sound program must read closer to
the reference than this does."""

from __future__ import annotations

import contextlib
from typing import Iterable

import torch
import torch.nn as nn
from torch.nn.utils import parametrize
from torch import Tensor

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
_LAYERS = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)


def fp8_round(x: Tensor) -> Tensor:
    """x through e4m3 and back, scaled so its largest magnitude maps to the
    format's largest. The gradient passes straight through to x, so a
    trained weight keeps its float32 master copy."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = FP8_MAX / amax
    rounded = ((x.detach().float() * scale).to(FP8).float() / scale).to(x.dtype)
    return x + (rounded - x).detach()


class _RoundFP8(nn.Module):
    def forward(self, w: Tensor) -> Tensor:
        return fp8_round(w)


def _round_input(module, args):
    return (fp8_round(args[0]),) + tuple(args[1:])


@contextlib.contextmanager
def fp8_layers(modules: Iterable[nn.Module]):
    """Inside: every linear and convolution under `modules` computes on fp8
    rounded inputs and weights (the weights rounded at each use)."""
    hooked, hooks = [], []
    try:
        for root in modules:
            for m in root.modules():
                if isinstance(m, _LAYERS):
                    parametrize.register_parametrization(m, "weight", _RoundFP8(), unsafe=True)
                    hooked.append(m)
                    hooks.append(m.register_forward_pre_hook(_round_input))
        yield
    finally:
        for h in hooks:
            h.remove()
        for m in hooked:
            parametrize.remove_parametrizations(m, "weight", leave_parametrized=False)


@contextlib.contextmanager
def tf32():
    """Inside: float32 matmuls and convolutions run in TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def no_tf32() -> None:
    """The reference's and the configurations' float32: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def bf16_compositor():
    """Inside: the reference renderer composites pair attributes (screen
    positions, conics, opacities, colors, depths) rounded to bfloat16."""
    from . import render

    plain = render.composite_tiles_diff

    def rounded(attrs, *args):
        return plain(attrs.to(torch.bfloat16).float(), *args)

    render.composite_tiles_diff = rounded
    try:
        yield
    finally:
        render.composite_tiles_diff = plain
