"""The 2-D AdaIN stylization baseline (counterpart of the 2-D half of
styl3r_tpu/models/stylizers.py; reference `src/test/vgg_model.py`): VGG19
relu4_1 features of the content and the style, AdaIN, and a decoder back
to an image. Not on the production path: validation logs it beside the
model's renders when `train.adain_baseline_weights` is set
(model_wrapper_style.py:260-308). NHWC images, as the JAX package's.

The modules keep the reference's key names below `vgg_encoder` (the
torchvision VGG19 `features.N`, as losses/vgg.py) and `decoder`
(`rcN.conv`), so convert_adain2d_checkpoint only renumbers the encoder's
slices.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from ..losses.vgg import VGG19Features


def adain(content: Tensor, style: Tensor, eps: float = 1e-8) -> Tensor:
    """Adaptive instance normalization of NHWC features
    (vgg_model.py:28-56): the content's channel statistics replaced by the
    style's (population standard deviations)."""
    c_mean = content.mean(dim=(1, 2), keepdim=True)
    c_std = content.std(dim=(1, 2), keepdim=True, unbiased=False) + eps
    s_mean = style.mean(dim=(1, 2), keepdim=True)
    s_std = style.std(dim=(1, 2), keepdim=True, unbiased=False) + eps
    return s_std * (content - c_mean) / c_std + s_mean


class ReflectConv(nn.Module):
    """A reflection-padded 3x3 conv (vgg_model.py's RC)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


# (input, output) channels of rc1..rc9; a 2x nearest upsample follows rc1,
# rc5 and rc7.
DECODER_CONVS = [(512, 256), (256, 256), (256, 256), (256, 256), (256, 128), (128, 128), (128, 64), (64, 64), (64, 3)]
UPSAMPLE_AFTER = (1, 5, 7)


class AdaInDecoder(nn.Module):
    """VGG relu4_1 features -> an image (vgg_model.py Decoder): 9
    reflection-padded convs, ReLU after all but the last, 3 upsamples."""

    def __init__(self):
        super().__init__()
        for i, (c_in, c_out) in enumerate(DECODER_CONVS, start=1):
            self.add_module(f"rc{i}", ReflectConv(c_in, c_out))

    def forward(self, x: Tensor) -> Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(1, len(DECODER_CONVS) + 1):
            x = getattr(self, f"rc{i}")(x)
            if i < len(DECODER_CONVS):
                x = F.relu(x)
            if i in UPSAMPLE_AFTER:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
        return x.permute(0, 2, 3, 1)


class AdaIN2D(nn.Module):
    """The 2-D AdaIN baseline (vgg_model.py AdaIN2D): (n, h, w, 3) content
    and style images in [0, 1] -> (n, h, w, 3) stylized images."""

    def __init__(self):
        super().__init__()
        self.vgg_encoder = VGG19Features()
        self.decoder = AdaInDecoder()

    def forward(self, content: Tensor, style: Tensor, alpha: float = 1.0) -> Tensor:
        n = content.shape[0]
        feats = self.vgg_encoder(torch.cat([content, style]))[-1]  # relu4_1
        cf, sf = feats[:n], feats[n:]
        t = adain(cf, sf)
        return self.decoder(alpha * t + (1 - alpha) * cf)


# The reference encoder's slices (slice1 = features[:2], slice2 = [2:7],
# slice3 = [7:12], slice4 = [12:21]) start at these torchvision indices.
_SLICE_OFFSETS = {"slice1": 0, "slice2": 2, "slice3": 7, "slice4": 12}


def convert_adain2d_checkpoint(state_dict: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """The reference AdaIN2D weights (ckpts/model_state.pth:
    vgg_encoder.sliceK.I.* and decoder.rcN.conv.*) -> AdaIN2D's state dict."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith("vgg_encoder."):
            _, slice_name, idx, param = key.split(".")
            out[f"vgg_encoder.features.{_SLICE_OFFSETS[slice_name] + int(idx)}.{param}"] = torch.as_tensor(value)
        elif key.startswith("decoder."):
            out[key] = torch.as_tensor(value)
    return out
