"""LPIPS perceptual distance, VGG16 variant (counterpart of
styl3r_tpu/losses/lpips.py; the reference uses the `lpips` package,
`src/loss/loss_lpips.py:27-54`).

VGG16 features at relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3 after the
package's scaling layer; channels unit-normalized; squared difference;
learned non-negative 1x1 `lin` weights; spatial mean; sum over layers. The
convs keep torchvision's key names (`features.N.weight`) and the lin weights
are `linI` vectors, so `convert_lpips_state` maps the package's and
torchvision's state dicts onto the module.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn as nn
from torch import Tensor

from .vgg import conv_features, conv_stack

# torchvision vgg16.features conv indices per LPIPS slice.
VGG16_SLICE_CONVS = [
    [(0, 3, 64), (2, 64, 64)],
    ["pool", (5, 64, 128), (7, 128, 128)],
    ["pool", (10, 128, 256), (12, 256, 256), (14, 256, 256)],
    ["pool", (17, 256, 512), (19, 512, 512), (21, 512, 512)],
    ["pool", (24, 512, 512), (26, 512, 512), (28, 512, 512)],
]
LPIPS_CHANNELS = (64, 128, 256, 512, 512)

# lpips package input scaling layer.
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


class LPIPSVgg16(nn.Module):
    """d(x, y) per image for NHWC images; with normalize, inputs in [0, 1]."""

    def __init__(self):
        super().__init__()
        self.features = conv_stack(VGG16_SLICE_CONVS)
        for i, c in enumerate(LPIPS_CHANNELS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(c)))

    def forward(self, x: Tensor, y: Tensor, normalize: bool = True) -> Tensor:
        if normalize:  # [0, 1] -> [-1, 1]
            x = 2.0 * x - 1.0
            y = 2.0 * y - 1.0
        shift = torch.tensor(LPIPS_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(LPIPS_SCALE, dtype=x.dtype, device=x.device)
        n = x.shape[0]
        feats = conv_features(self.features, VGG16_SLICE_CONVS, (torch.cat([x, y]) - shift) / scale)
        total = 0.0
        for i, f in enumerate(feats):
            f = f / torch.sqrt((f**2).sum(dim=-1, keepdim=True) + 1e-10)
            diff = (f[:n] - f[n:]) ** 2
            # The package's lin layers are non-negative 1x1 convs.
            val = (diff * torch.clamp(getattr(self, f"lin{i}"), min=0.0)).sum(dim=-1)
            total = total + val.mean(dim=(1, 2))
        return total


def convert_lpips_state(lpips_state: Mapping, vgg16_state: Mapping) -> Dict[str, Tensor]:
    """The lpips package's state dict (lin weights, 'lin0.model.1.weight' or
    'lins.0.model.1.weight') and a torchvision vgg16 state dict -> a state
    dict for LPIPSVgg16."""
    out = {}
    for spec in VGG16_SLICE_CONVS:
        for layer in spec:
            if layer != "pool":
                for kind in ("weight", "bias"):
                    out[f"features.{layer[0]}.{kind}"] = torch.as_tensor(vgg16_state[f"features.{layer[0]}.{kind}"])
    for i in range(len(LPIPS_CHANNELS)):
        key = f"lin{i}.model.1.weight"
        if key not in lpips_state:
            key = f"lins.{i}.model.1.weight"
        out[f"lin{i}"] = torch.as_tensor(lpips_state[key]).reshape(-1)
    return out
