"""Weights drawn as flax's default initializers draw them (frozen copy of
styl3r_tpu_torch/utils/convert.py::init_like_flax_): lecun-normal kernels,
zero biases, LayerNorm ones and zeros. The benchmark draws every weight of
a configuration with this rule from the configuration's fixed seed, on the
device, into the reference's modules, whose state dict the program then
loads by key name."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_like_flax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    for m in module.modules():
        if isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = w.shape[0]
            else:
                fan_in = w.shape[1] * math.prod(w.shape[2:])
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    return module


def drawn(make, seed: int, device) -> nn.Module:
    """`make()` built without torch's own init (on the meta device), put on
    `device` and drawn from a generator on `device` seeded with `seed`."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device)
    return init_like_flax_(module, torch.Generator(device).manual_seed(seed))
