"""The DPT heads' 3x3, stride-1 convolutions (models/dpt.py).

`conv3x3(x, conv, relu)` computes `conv(x)`, then the ReLU with `relu`, for
an `nn.Conv2d` whose weight and bias it reads as they are, so the module's
state-dict keys do not change. It takes one launch of csrc/conv3x3_f32.cu
(float32 FFMA, bias and ReLU in its epilogue) when all of these hold:

- x is a CUDA float32 tensor and the weight is float32;
- cuDNN may not use TF32 (`torch.backends.cudnn.allow_tf32` is False) and
  autocast is off on x's device, so `conv(x)` would compute in float32;
- the conv is 3x3, stride 1, zero padding 1, dilation 1, groups 1.

Otherwise it calls `conv(x)` (and F.relu), as the heads did before: on CPU
tensors, in bfloat16, under TF32 or autocast. The gradient of a routed call
is `torch.ops.aten.convolution_backward`, the cuDNN calls F.conv2d's
autograd makes. The plain version of the kernel is F.conv2d with TF32 off.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from ..utils import cuda_build

TILE_CHANNELS = 128  # the kernel's block tile: output channels
# Its output pixels, each with the blocks an SM holds at once: the wide
# tile takes a quarter fewer shared-memory loads an FFMA; the narrow one
# fills the card on small grids.
WIDE, NARROW = (256, 1), (128, 2)
CHUNK_CHANNELS = 4  # input channels a K step of the kernel takes
MIN_CHUNKS_PER_SPLIT = 4  # the least K a block of a split tile takes (144 k values)
MAX_SPLITS = 32


def routed(x: Tensor, conv: nn.Conv2d) -> bool:
    """Whether conv3x3 takes the kernel for conv(x) (the module docstring's
    conditions)."""
    return (x.is_cuda and x.dtype is torch.float32 and conv.weight.dtype is torch.float32
            and not torch.backends.cudnn.allow_tf32 and not torch.is_autocast_enabled(x.device.type)
            and conv.kernel_size == (3, 3) and conv.stride == (1, 1) and conv.padding == (1, 1)
            and conv.dilation == (1, 1) and conv.groups == 1 and conv.padding_mode == "zeros")


def tiles(pixels: int, cout: int, tile_pixels: int) -> int:
    return -(-pixels // tile_pixels) * -(-cout // TILE_CHANNELS)


@lru_cache(maxsize=None)
def plan(pixels: int, cout: int, cin: int, sms: int) -> Tuple[int, int, int]:
    """(tile_pixels, splits, chunks_per_split) of a launch on a card of
    `sms` SMs: the wide tile where its tiles fill the SMs one and a half
    times over (on the H100 it is then the faster), else the narrow one,
    with K split over blocks where its tiles alone would leave SMs idle, as
    far as keeps MIN_CHUNKS_PER_SPLIT chunks a block."""
    chunks = -(-cin // CHUNK_CHANNELS)
    if 2 * tiles(pixels, cout, WIDE[0]) >= 3 * WIDE[1] * sms:
        return WIDE[0], 1, chunks
    tile_pixels, per_sm = NARROW
    want = min(per_sm * sms // tiles(pixels, cout, tile_pixels), chunks // MIN_CHUNKS_PER_SPLIT, MAX_SPLITS)
    if want <= 1:
        return tile_pixels, 1, chunks
    per = -(-chunks // want)
    return tile_pixels, -(-chunks // per), per


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x: Tensor, weight: Tensor, bias: Optional[Tensor], relu: bool) -> Tensor:
    """One kernel launch: relu?(conv3x3(x, weight) + bias), a new contiguous
    (n, cout, h, w) float32 tensor."""
    if x.dim() != 4 or weight.shape[1:] != (x.shape[1], 3, 3) or (bias is not None and (
            bias.dtype is not torch.float32 or bias.shape != weight.shape[:1])):
        raise ValueError(f"conv3x3: x must be (n, cin, h, w), weight (cout, cin, 3, 3) and bias (cout,) float32; "
                         f"got x {tuple(x.shape)}, weight {tuple(weight.shape)}, "
                         f"bias {None if bias is None else (bias.dtype, tuple(bias.shape))}")
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    dev = x.device
    if weight.device != dev or (bias is not None and bias.device != dev):
        raise ValueError(f"conv3x3: x on {dev}, weight on {weight.device}"
                         + ("" if bias is None else f", bias on {bias.device}"))
    if max(cin, cout) * h * w >= 2**31:
        raise ValueError(f"conv3x3: an image's channels must hold fewer than 2^31 values; got cin {cin}, "
                         f"cout {cout} at {h}x{w}")
    x = x.contiguous()
    weight = weight.contiguous()
    y = x.new_empty((n, cout, h, w))
    tile_pixels, splits, per = plan(n * h * w, cout, cin, _sm_count(dev.index))
    workspace = counters = None
    if splits > 1:
        count = tiles(n * h * w, cout, tile_pixels)
        workspace = x.new_empty(count * splits * tile_pixels * TILE_CHANNELS)
        counters = torch.zeros(count, dtype=torch.int32, device=dev)  # the blocks done, a tile
    cuda_build.launch(
        "conv3x3_f32", dev, x.data_ptr(), weight.data_ptr(), None if bias is None else bias.contiguous().data_ptr(),
        y.data_ptr(), n, cin, h, w, cout, int(relu), tile_pixels, splits, per,
        None if workspace is None else workspace.data_ptr(), None if counters is None else counters.data_ptr())
    return y


class _Conv3x3(torch.autograd.Function):
    """The kernel's forward; the backward is convolution_backward on the
    saved input and weight (after the ReLU's mask, where fused), as
    F.conv2d's autograd (and F.relu's) computes it."""

    @staticmethod
    def forward(ctx, x, weight, bias, relu):
        y = _launch(x, weight, bias, relu)
        ctx.relu, ctx.has_bias = relu, bias is not None
        ctx.save_for_backward(x, weight, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight, y = ctx.saved_tensors
        if ctx.relu:
            gy = torch.ops.aten.threshold_backward(gy, y, 0)
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], ctx.has_bias and ctx.needs_input_grad[2]]
        gx, gw, gb = torch.ops.aten.convolution_backward(
            gy, x, weight, [weight.shape[0]] if ctx.has_bias else None,
            [1, 1], [1, 1], [1, 1], False, [0, 0], 1, mask)
        return gx, gw, gb, None


def conv3x3(x: Tensor, conv: nn.Conv2d, relu: bool = False) -> Tensor:
    """conv(x), then F.relu with `relu`: the kernel where `routed`, else
    the module's own forward."""
    if not routed(x, conv):
        y = conv(x)
        return F.relu(y) if relu else y
    weight, bias = conv.weight, conv.bias
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or (bias is not None and bias.requires_grad)):
        return _Conv3x3.apply(x, weight, bias, relu)
    return _launch(x, weight, bias, relu)
