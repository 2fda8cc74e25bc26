"""Weights between the JAX package's flax params and the port's modules.

The port's modules carry the reference's torch key names (the ones
styl3r_tpu/utils/checkpoint.py reads, and torchvision's for the perceptual
nets), so `from_jax_params` inverts that file's layout rules: linear kernels transpose, HWIO conv kernels become
OIHW, and a PatchExpand dense becomes the ConvTranspose2d it replaces.
PatchExpand's bias is the ConvTranspose bias tiled k*k times; the inverse
keeps the first copy and raises if the copies differ.

`init_like_flax_` draws weights the way flax's default initializers do, so
a randomly initialized port produces Gaussians at the scale of a randomly
initialized JAX model.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn


def _linear(p: Mapping, out: Dict, name: str) -> None:
    out[f"{name}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])


def _conv(p: Mapping, out: Dict, name: str) -> None:
    out[f"{name}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])


def _layernorm(p: Mapping, out: Dict, name: str) -> None:
    out[f"{name}.weight"] = np.asarray(p["scale"])
    out[f"{name}.bias"] = np.asarray(p["bias"])


def _patch_expand(p: Mapping, out: Dict, name: str, k: int) -> None:
    kernel = np.asarray(p["expand"]["kernel"])  # (in, k*k*out), [(dy*k+dx)*out + o]
    bias = np.asarray(p["expand"]["bias"]).reshape(k * k, -1)
    if not (bias == bias[:1]).all():
        raise ValueError(f"{name}: PatchExpand bias is not one ConvTranspose bias tiled {k * k} times")
    in_ch, out_ch = kernel.shape[0], bias.shape[1]
    out[f"{name}.weight"] = kernel.reshape(in_ch, k, k, out_ch).transpose(0, 3, 1, 2)
    out[f"{name}.bias"] = bias[0]


def _block(p: Mapping, out: Dict, name: str) -> None:
    for norm in ("norm1", "norm2", "norm3", "norm_y"):
        if norm in p:
            _layernorm(p[norm], out, f"{name}.{norm}")
    for proj in ("qkv", "proj"):
        _linear(p["attn"][proj], out, f"{name}.attn.{proj}")
    if "cross_attn" in p:
        for proj in ("projq", "projk", "projv", "proj"):
            _linear(p["cross_attn"][proj], out, f"{name}.cross_attn.{proj}")
    for fc in ("fc1", "fc2"):
        _linear(p["mlp"][fc], out, f"{name}.mlp.{fc}")


def _numbered(p: Mapping, prefix: str):
    i = 0
    while f"{prefix}_{i}" in p:
        yield i, p[f"{prefix}_{i}"]
        i += 1


def _croco(p: Mapping, out: Dict, name: str) -> None:
    """A CroCo stack: its encoder, intrinsics token and decoder(s), each
    where the stack has one (CrocoEncBackbone has no decoder,
    StructureBuilder no encoder)."""
    if "encoder" in p:
        enc = p["encoder"]
        _conv(enc["patch_embed"]["proj"], out, f"{name}.patch_embed.proj")
        for i, blk in _numbered(enc, "enc_blocks"):
            _block(blk, out, f"{name}.enc_blocks.{i}")
        _layernorm(enc["enc_norm"], out, f"{name}.enc_norm")
    if "intrinsic_encoder" in p:
        _linear(p["intrinsic_encoder"], out, f"{name}.intrinsic_encoder")
    if "decoder_embed" in p:
        _linear(p["decoder_embed"], out, f"{name}.decoder_embed")
    for stack in ("dec_blocks", "dec_blocks2"):
        for i, blk in _numbered(p, stack):
            _block(blk, out, f"{name}.{stack}.{i}")
    if "dec_norm" in p:
        _layernorm(p["dec_norm"], out, f"{name}.dec_norm")


def _trunk(p: Mapping, out: Dict, name: str) -> None:
    ap = f"{name}.act_postprocess"
    _conv(p["act_0_proj"], out, f"{ap}.0.0")
    _patch_expand(p["act_0_up"], out, f"{ap}.0.1", 4)
    _conv(p["act_1_proj"], out, f"{ap}.1.0")
    _patch_expand(p["act_1_up"], out, f"{ap}.1.1", 2)
    _conv(p["act_2_proj"], out, f"{ap}.2.0")
    _conv(p["act_3_proj"], out, f"{ap}.3.0")
    _conv(p["act_3_down"], out, f"{ap}.3.1")
    for i in range(1, 5):
        _conv(p[f"layer{i}_rn"], out, f"{name}.scratch.layer{i}_rn")
        rp = p[f"refinenet{i}"]
        for unit in ("resConfUnit1", "resConfUnit2"):
            if unit in rp:
                for conv in ("conv1", "conv2"):
                    _conv(rp[unit][conv], out, f"{name}.scratch.refinenet{i}.{unit}.{conv}")
        _conv(rp["out_conv"], out, f"{name}.scratch.refinenet{i}.out_conv")


def _pts3d_head(p: Mapping, out: Dict, name: str) -> None:
    _trunk(p["trunk"], out, f"{name}.dpt")
    for flax_name, idx in (("head_conv1", 0), ("head_conv2", 2), ("head_conv3", 4)):
        _conv(p[flax_name], out, f"{name}.dpt.head.{idx}")


def _gs_head(p: Mapping, out: Dict, name: str) -> None:
    _trunk(p["trunk"], out, f"{name}.dpt")
    _conv(p["head"]["head_conv1"], out, f"{name}.dpt.head.0")
    _conv(p["head"]["head_conv2"], out, f"{name}.dpt.head.4")
    if "input_merger" in p:
        _conv(p["input_merger"], out, f"{name}.dpt.input_merger.0")


# Each model's flax subtrees: (converter, the port's module name).
_LAYOUTS = {
    "styl3r": {
        "backbone": (_croco, "backbone"),
        "token_stylizer": (_croco, "token_stylizer"),
        "head1": (_pts3d_head, "downstream_head1"),
        "head2": (_pts3d_head, "downstream_head2"),
        "gaussian_param_head": (_gs_head, "gaussian_param_head"),
        "gaussian_param_head2": (_gs_head, "gaussian_param_head2"),
        "gaussian_appearance_head": (_gs_head, "gaussian_appearance_head"),
    },
    "token_style_2view": {
        "backbone": (_croco, "backbone"),
        "structure_builder": (_croco, "structure_builder"),
        "token_stylizer": (_croco, "token_stylizer"),
        "head1": (_pts3d_head, "downstream_head1"),
        "gaussian_structure_head": (_gs_head, "gaussian_structure_head"),
        "gaussian_appearance_head": (_gs_head, "gaussian_appearance_head"),
    },
    "noposplat_multi": {
        "backbone": (_croco, "backbone"),
        "head1": (_pts3d_head, "downstream_head1"),
        "head2": (_pts3d_head, "downstream_head2"),
        "gaussian_param_head": (_gs_head, "gaussian_param_head"),
        "gaussian_param_head2": (_gs_head, "gaussian_param_head2"),
    },
    "teacher": {
        "backbone": (_croco, "backbone"),
        "downstream_head1": (_pts3d_head, "downstream_head1"),
        "downstream_head2": (_pts3d_head, "downstream_head2"),
    },
}


def _perceptual(p: Mapping, out: Dict) -> None:
    """VGG19Features / LPIPSVgg16: `convN` -> `features.N`, `linI` as is."""
    for name, leaf in p.items():
        if name.startswith("conv"):
            _conv(leaf, out, f"features.{name[4:]}")
        else:
            out[name] = np.asarray(leaf)


def _join(name: str, key: str) -> str:
    return f"{name}.{key}" if name else key


def _conv1d(p: Mapping, out: Dict, name: str) -> None:
    """A flax Dense in place of a kernel-1 Conv1d."""
    out[f"{name}.weight"] = np.asarray(p["kernel"]).T[:, :, None]
    out[f"{name}.bias"] = np.asarray(p["bias"])


def _frozen_bn(p: Mapping, out: Dict, name: str, eps: float = 1e-5) -> None:
    """FrozenNorm's folded scale and bias -> an eval-mode BatchNorm with
    zero mean and unit variance (running_var + eps = 1)."""
    scale = np.asarray(p["scale"])
    out[f"{name}.weight"] = scale
    out[f"{name}.bias"] = np.asarray(p["bias"])
    out[f"{name}.running_mean"] = np.zeros_like(scale)
    out[f"{name}.running_var"] = np.full_like(scale, 1.0 - eps)
    out[f"{name}.num_batches_tracked"] = np.zeros(())


def _resnet_trunk(p: Mapping, out: Dict, name: str) -> None:
    """ResNetTrunk: `layerL_B` -> torchvision's `layerL.B`; norms only where
    they hold weights (dino_resnet50's BatchNorm)."""
    _conv(p["conv1"], out, _join(name, "conv1"))
    if "bn1" in p:
        _frozen_bn(p["bn1"], out, _join(name, "bn1"))
    for key, block in p.items():
        if not key.startswith("layer"):
            continue
        layer, index = key[len("layer"):].split("_")
        prefix = _join(name, f"layer{layer}.{index}")
        for sub, leaf in block.items():
            if sub == "downsample_conv":
                _conv(leaf, out, f"{prefix}.downsample.0")
            elif sub == "downsample_norm":
                _frozen_bn(leaf, out, f"{prefix}.downsample.1")
            elif sub.startswith("conv"):
                _conv(leaf, out, f"{prefix}.{sub}")
            else:
                _frozen_bn(leaf, out, f"{prefix}.{sub}")


def _backbone_resnet(p: Mapping, out: Dict, name: str) -> None:
    _resnet_trunk(p["model"], out, _join(name, "model"))
    for key, leaf in p.items():
        if key.startswith("projection"):
            _conv(leaf, out, _join(name, f"projections.layer{key[len('projection'):]}"))


def _dino_vit(p: Mapping, out: Dict, name: str) -> None:
    out[_join(name, "cls_token")] = np.asarray(p["cls_token"])
    out[_join(name, "pos_embed")] = np.asarray(p["pos_embed"])
    _conv(p["patch_embed"], out, _join(name, "patch_embed.proj"))
    _layernorm(p["norm"], out, _join(name, "norm"))
    i = 0
    while f"blocks_{i}_norm1" in p:
        block = _join(name, f"blocks.{i}")
        for norm in ("norm1", "norm2"):
            _layernorm(p[f"blocks_{i}_{norm}"], out, f"{block}.{norm}")
        for flax_name, port_name in (("qkv", "attn.qkv"), ("proj", "attn.proj"), ("fc1", "mlp.fc1"),
                                     ("fc2", "mlp.fc2")):
            _linear(p[f"blocks_{i}_{flax_name}"], out, f"{block}.{port_name}")
        i += 1


def _backbone_dino(p: Mapping, out: Dict, name: str) -> None:
    _backbone_resnet(p["resnet_backbone"], out, _join(name, "resnet_backbone"))
    _dino_vit(p["dino"], out, _join(name, "dino"))
    for mlp in ("global_token_mlp", "local_token_mlp"):
        _linear(p[f"{mlp}_fc1"], out, _join(name, f"{mlp}.0"))
        _linear(p[f"{mlp}_fc2"], out, _join(name, f"{mlp}.2"))


def _normalized_vgg(p: Mapping, out: Dict, name: str) -> None:
    """`conv<index>` -> make_vgg's `<index>`. A flax NormalizedVGG holds only
    the convs its forward runs; the port's holds all of make_vgg's."""
    for key, leaf in p.items():
        _conv(leaf, out, _join(name, key[len("conv"):]))


def _mlp1d(p: Mapping, out: Dict, name: str) -> None:
    """MLP1d's `fc<i>` -> the Conv1d at Sequential index 2i."""
    for key, leaf in p.items():
        _conv1d(leaf, out, _join(name, str(2 * int(key[len("fc"):]))))


def _lst(p: Mapping, out: Dict, name: str) -> None:
    for net in ("c_net", "s_net"):
        n = len(p[net])
        for i in range(n):
            _conv1d(p[net][f"fc{i}"], out, _join(name, f"{net}.{i}.0" if i < n - 1 else f"{net}.{i}"))
    for conv in ("c_zipper", "c_unzipper"):
        _conv1d(p[conv], out, _join(name, conv))
    for fc in ("c_fc", "s_fc"):
        _linear(p[fc], out, _join(name, fc))


def _stylizer3d(p: Mapping, out: Dict, name: str) -> None:
    """Linear3DStylizer, AdaIN3DStylizer or AdaAttN3DStylizer."""
    for key, leaf in p.items():
        child = _join(name, key)
        if key == "vgg":
            _normalized_vgg(leaf, out, child)
        elif key == "lst":
            _lst(leaf, out, child)
        elif key.endswith("zipper"):
            _mlp1d(leaf, out, child)
        else:  # q_embed, k_embed, s_embed
            _conv1d(leaf, out, child)


# Whole modules whose flax params map onto the port's module of that kind.
_MODULES = {
    "backbone_resnet": _backbone_resnet,
    "backbone_dino": _backbone_dino,
    "normalized_vgg": _normalized_vgg,
    "lst": _lst,
    "stylizer3d": _stylizer3d,
}


def from_jax_params(
    params: Mapping, prefix: Optional[str] = None, model: str = "styl3r"
) -> Dict[str, torch.Tensor]:
    """Flax params ({'params': ...}, arrays) -> a state dict, as CPU tensors.

    model "styl3r": Styl3rEncoder params -> Styl3rModel, keys under `prefix`
    (default "encoder."); "token_style_2view" / "noposplat_multi":
    Styl3rTokenStyleEncoder2View / NoPoSplatMultiEncoder params -> the
    port's encoders of the same names; "teacher": Dust3RTeacher params ->
    models/distiller.py's; "vgg19" / "lpips": VGG19Features / LPIPSVgg16
    params -> the port's modules of the same names (losses/);
    "backbone_resnet" / "backbone_dino" / "normalized_vgg" / "lst":
    BackboneResnet / BackboneDino (models/backbones.py), NormalizedVGG / LST
    (models/stylizers.py); "stylizer3d": Linear3DStylizer, AdaIN3DStylizer or
    AdaAttN3DStylizer. A NormalizedVGG's convs past its layer are not in the
    flax params: load those with strict=False. Only "styl3r" has a default
    prefix."""
    p = params["params"] if "params" in params else params
    out: Dict[str, np.ndarray] = {}
    if model in ("vgg19", "lpips"):
        _perceptual(p, out)
    elif model in _MODULES:
        _MODULES[model](p, out, "")
    elif model in _LAYOUTS:
        if model == "styl3r" and prefix is None:
            prefix = "encoder."
        for flax_name, (kind, name) in _LAYOUTS[model].items():
            kind(p[flax_name], out, name)
    else:
        raise ValueError(f"unknown model {model!r}")
    prefix = prefix or ""
    return {
        prefix + k: torch.from_numpy(np.ascontiguousarray(np.asarray(v, dtype=np.float32)))
        for k, v in out.items()
    }


# flax's lecun_normal: a normal truncated to +-2 stddev, rescaled so that the
# truncated distribution has variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_like_flax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every weight of `module` in place the way flax's defaults do:
    lecun-normal kernels (fan_in = input features x receptive field; for a
    k=s ConvTranspose2d, its input channels, as for the flax dense it
    replaces), zero biases, LayerNorm and BatchNorm ones and zeros, and
    DinoViT's zero cls token and N(0, 0.02) position embedding."""
    from ..models.backbones import DinoViT

    for m in module.modules():
        if isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            if m.weight is not None:  # a LayerNorm without affine has nothing to draw
                m.weight.fill_(1.0)
                m.bias.zero_()
        elif isinstance(m, DinoViT):
            m.cls_token.zero_()
            nn.init.normal_(m.pos_embed, 0.0, 0.02, generator=generator)
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
