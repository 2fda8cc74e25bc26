"""[Frozen copy of styl3r_tpu_torch/losses/vgg.py, the benchmark's reference: it
imports nothing of the program.]

VGG19 feature extractor for the style and identity losses (counterpart
of styl3r_tpu/losses/vgg.py; reference `src/test/vgg_model.py:79-98`).

The four torchvision `vgg19().features` slices ending at relu1_1, relu2_1,
relu3_1 and relu4_1. The convs keep torchvision's key names
(`features.N.weight`), so a torchvision VGG19 state dict loads with a plain
`load_state_dict(..., strict=False)` (the layers past relu4_1 are unused).
No weights ship with the repo: without them the nets are drawn the way
flax's defaults draw them (`init_like_flax_`), and the losses' math, not the
features, is what the tests hold.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

# torchvision vgg19.features conv indices per slice; "pool" is a 2x2 max pool.
VGG19_SLICE_CONVS = [
    [(0, 3, 64)],
    [(2, 64, 64), "pool", (5, 64, 128)],
    [(7, 128, 128), "pool", (10, 128, 256)],
    [(12, 256, 256), (14, 256, 256), (16, 256, 256), "pool", (19, 256, 512)],
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(images: Tensor) -> Tensor:
    """[0, 1] RGB (..., h, w, 3) -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def conv_stack(slices) -> nn.ModuleDict:
    """The 3x3 convs of `slices`, keyed by their torchvision index."""
    return nn.ModuleDict({
        str(layer[0]): nn.Conv2d(layer[1], layer[2], 3, padding=1)
        for spec in slices for layer in spec if layer != "pool"
    })


def conv_features(convs: nn.ModuleDict, slices, x: Tensor) -> List[Tensor]:
    """Run 3x3 conv + ReLU / 2x2 max-pool slices over NHWC `x`; returns each
    slice's NHWC output (NCHW inside)."""
    x = x.permute(0, 3, 1, 2)
    outs = []
    for spec in slices:
        for layer in spec:
            if layer == "pool":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(convs[str(layer[0])](x))
        outs.append(x.permute(0, 2, 3, 1))
    return outs


class VGG19Features(nn.Module):
    """[relu1_1, relu2_1, relu3_1, relu4_1] features of NHWC input."""

    def __init__(self):
        super().__init__()
        self.features = conv_stack(VGG19_SLICE_CONVS)

    def forward(self, x: Tensor) -> List[Tensor]:
        return conv_features(self.features, VGG19_SLICE_CONVS, x)
