"""Reading the reference's torch checkpoints into the port's model
(counterpart of the torch-checkpoint half of styl3r_tpu/utils/checkpoint.py).

The port's modules carry the reference's Lightning key names
(`encoder.backbone.enc_blocks.0...`), so a released .ckpt/.pth loads by key,
and a warm start (main_style.py:128-168) is a partial state dict: the
checkpoint's keys filtered and renamed, loaded with
`load_state_dict(strict=False)` over the model's init (`load_warm_start`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn
from torch import Tensor

# Released checkpoints hold each DPT trunk's refinenet4.resConfUnit1, which
# neither the reference's model nor the port's uses.
UNUSED_KEY = ".refinenet4.resConfUnit1."


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The raw state dict of a torch .ckpt/.pth, unwrapping Lightning's
    'state_dict' and MASt3R's 'model'. torch.load unpickles the file, as the
    reference does: pass only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        if "state_dict" in ckpt:
            return ckpt["state_dict"]
        if "model" in ckpt:
            return ckpt["model"]
    return ckpt


def reject_directory(path) -> None:
    """The port reads checkpoint files; a directory is an orbax checkpoint of
    the JAX package, which scripts/orbax_to_torch.py converts."""
    if Path(path).is_dir():
        raise ValueError(
            f"{path} is a directory: the port does not read the JAX package's orbax checkpoints; convert "
            f"it with `python scripts/orbax_to_torch.py {path} <out.pth>` (where JAX and orbax are "
            "installed) and pass the .pth, or pass a torch .ckpt, .pth or a checkpoint the port's trainer wrote"
        )


def model_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The model's weights in a checkpoint file (a reference .ckpt/.pth or a
    trainer checkpoint's "model" entry), without the unused
    refinenet4.resConfUnit1 entries."""
    reject_directory(path)
    return {k: v for k, v in load_torch_state_dict(path).items() if UNUSED_KEY not in k}


def load_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Load a torch checkpoint into `model` by key. The unused
    refinenet4.resConfUnit1 entries are dropped, and so are the keys under
    the model's `IGNORED_KEY_PREFIXES` (VGGT's released `model.pt` holds its
    tracking head, which models/vggt.py leaves out); any other missing or
    unexpected key raises."""
    ignored = tuple(getattr(model, "IGNORED_KEY_PREFIXES", ()))
    sd = model_state_dict(path)
    model.load_state_dict({k: v for k, v in sd.items() if not (ignored and k.startswith(ignored))}, strict=True)
    return model


def _with_prefix(sd: Mapping[str, Tensor], prefix: str, new_prefix: str) -> Dict[str, Tensor]:
    """The entries under `prefix`, moved under `new_prefix`, without the
    unused refinenet4.resConfUnit1 entries."""
    return {
        new_prefix + k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix) and UNUSED_KEY not in k
    }


def _duplicate_dec_blocks(sd: Dict[str, Tensor], backbone: str = "encoder.backbone.") -> Dict[str, Tensor]:
    """A CroCo checkpoint without the second view's decoder (dec_blocks2)
    seeds it from dec_blocks (backbone_croco_multiview.py:100-107)."""
    if not any(k.startswith(backbone + "dec_blocks2.") for k in sd):
        src = backbone + "dec_blocks."
        sd.update({backbone + "dec_blocks2." + k[len(src):]: v for k, v in sd.items() if k.startswith(src)})
    return sd


def split_noposplat_gs_head(
    sd: Mapping[str, Tensor], d_sh: int, prefix: str = "encoder.gaussian_param_head."
) -> Dict[str, Dict[str, Tensor]]:
    """NoPoSplat -> Styl3R: the last gs-head conv's rows [:-3*d_sh] go to
    the structure head, rows [-3*d_sh:] to the appearance head
    (main_style.py:146-152). Returns {'structure': ..., 'appearance': ...},
    each a state dict keyed like a bare gs head (`dpt.head.4.weight`)."""
    head = _with_prefix(sd, prefix, "")
    structure, appearance = dict(head), dict(head)
    for name in ("dpt.head.4.weight", "dpt.head.4.bias"):
        structure[name] = head[name][: -3 * d_sh]
        appearance[name] = head[name][-3 * d_sh :]
    return {"structure": structure, "appearance": appearance}


def convert_noposplat_encoder(sd: Mapping[str, Tensor], sh_degree: int = 0) -> Dict[str, Tensor]:
    """A NoPoSplat release .ckpt -> the Styl3R model's keys it seeds
    (main_style.py:136-152): the backbone and the pts3d heads as they are;
    each gs head keeps its structure rows; the appearance head takes the
    view-0 gs head's trunk and first conv, with the SH rows of its last conv
    (and no input merger)."""
    d_sh = (sh_degree + 1) ** 2
    out = _duplicate_dec_blocks(_with_prefix(sd, "encoder.backbone.", "encoder.backbone."))
    for name in ("downstream_head1", "downstream_head2"):
        out.update(_with_prefix(sd, f"encoder.{name}.", f"encoder.{name}."))
    for name in ("gaussian_param_head", "gaussian_param_head2"):
        split = split_noposplat_gs_head(sd, d_sh, prefix=f"encoder.{name}.")
        out.update({f"encoder.{name}.{k}": v for k, v in split["structure"].items()})
    split0 = split_noposplat_gs_head(sd, d_sh, prefix="encoder.gaussian_param_head.")
    out.update({
        f"encoder.gaussian_appearance_head.{k}": v
        for k, v in split0["appearance"].items() if not k.startswith("dpt.input_merger.")
    })
    return out


_STYLIZER_ENCODER_KEYS = ("patch_embed.", "enc_blocks.", "enc_norm.")
_DECODER_KEYS = ("decoder_embed.", "dec_blocks.", "dec_norm.")


def _under(sd: Mapping[str, Tensor], prefix: str, keep: Tuple[str, ...]) -> Dict[str, Tensor]:
    """The entries under `prefix` whose name below it starts with one of
    `keep`, without the prefix."""
    return {k: v for k, v in _with_prefix(sd, prefix, "").items() if k.startswith(keep)}


def convert_structure_builder(sd: Mapping[str, Tensor], prefix: str = "structure_builder") -> Dict[str, Tensor]:
    """The 2-view encoder's structure builder -> a bare StructureBuilder's
    keys (its decoder embedding, blocks and norm)."""
    return _under(sd, prefix + ".", _DECODER_KEYS)


def convert_croco_enc_backbone(sd: Mapping[str, Tensor], prefix: str = "backbone") -> Dict[str, Tensor]:
    """An encoder-only CroCo (AsymmetricCroCoEnc) -> a bare CrocoEncBackbone's
    keys (its encoder and, where there is one, the intrinsics token)."""
    return _under(sd, prefix + ".", _STYLIZER_ENCODER_KEYS + ("intrinsic_encoder.",))


def convert_token_style_encoder(state_dict: Mapping[str, Tensor], prefix: str = "encoder.") -> Dict[str, Tensor]:
    """A 2-view EncoderNoPoSplatTokenStyle checkpoint
    (encoder_noposplat_token_style.py:150-283) -> Styl3rTokenStyleEncoder2View's
    keys."""
    sd = _with_prefix(state_dict, prefix, "")
    out = {f"backbone.{k}": v for k, v in convert_croco_enc_backbone(sd).items()}
    out.update({f"structure_builder.{k}": v for k, v in convert_structure_builder(sd).items()})
    out.update({
        f"token_stylizer.{k}": v
        for k, v in _under(sd, "token_stylizer.", _STYLIZER_ENCODER_KEYS + _DECODER_KEYS).items()
    })
    for name in ("downstream_head1", "gaussian_structure_head", "gaussian_appearance_head"):
        out.update(_with_prefix(sd, f"{name}.", f"{name}."))
    return out


def convert_noposplat_multi_encoder(state_dict: Mapping[str, Tensor], prefix: str = "encoder.") -> Dict[str, Tensor]:
    """A NoPoSplat checkpoint -> NoPoSplatMultiEncoder's keys: the style-free
    architecture itself, its full-width gs heads as they are (no row split),
    dec_blocks2 seeded from dec_blocks where the checkpoint has none."""
    sd = _with_prefix(state_dict, prefix, "")
    out = _duplicate_dec_blocks(_with_prefix(sd, "backbone.", "backbone."), backbone="backbone.")
    for name in ("downstream_head1", "downstream_head2", "gaussian_param_head", "gaussian_param_head2"):
        out.update(_with_prefix(sd, f"{name}.", f"{name}."))
    return out


def convert_mast3r_backbone(sd: Mapping[str, Tensor], patch_size: Optional[int] = None) -> Dict[str, Tensor]:
    """A raw MASt3R/DUSt3R `model` dict -> the backbone's keys only (the
    reference's checkpoint_filter_fn + strict=False load, main_style.py:130-135);
    the heads keep their init. With `patch_size`, a patch embedding of
    another size is resampled (resample_patch_embed_kernel)."""
    out = _duplicate_dec_blocks(_with_prefix(sd, "", "encoder.backbone."))
    key = "encoder.backbone.patch_embed.proj.weight"
    if patch_size is not None and key in out and out[key].shape[-1] != patch_size:
        out[key] = resample_patch_embed_kernel(out[key], (patch_size, patch_size))
    return out


_STYLIZER_KEYS = _STYLIZER_ENCODER_KEYS + _DECODER_KEYS


def convert_stylizer_weights(sd: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """The token stylizer's warm start (main_style.py:156-168): a raw MASt3R
    `model` dict seeds its encoder and decoder; a NoPoSplat Lightning ckpt
    seeds only its encoder, from `encoder.backbone.*`."""
    if any(k.startswith("encoder.backbone.") for k in sd):
        src, keep = "encoder.backbone.", _STYLIZER_ENCODER_KEYS
    else:
        src, keep = "", _STYLIZER_KEYS
    return {
        k: v for k, v in _with_prefix(sd, src, "encoder.token_stylizer.").items()
        if k[len("encoder.token_stylizer."):].startswith(keep)
    }


def warm_start_encoder_params(sd: Mapping[str, Tensor], sh_degree: int = 0) -> Dict[str, Tensor]:
    """Dispatch on the checkpoint's flavor, as the reference's warm start
    does (main_style.py:128-155): a full Styl3R ckpt seeds the whole
    encoder; a NoPoSplat ckpt the backbone and heads, with the gs-head row
    split; a raw MASt3R `model` dict the backbone only."""
    if any(k.startswith("encoder.token_stylizer.") for k in sd):
        return _duplicate_dec_blocks(_with_prefix(sd, "encoder.", "encoder."))
    if any(k.startswith("encoder.") for k in sd):
        return convert_noposplat_encoder(sd, sh_degree)
    return convert_mast3r_backbone(sd)


def load_warm_start(model: nn.Module, partial: Mapping[str, Tensor]) -> List[str]:
    """Load a partial state dict over the model's weights
    (`load_state_dict(strict=False)`, what the reference's warm starts call).
    Returns the checkpoint's keys the model has no place for, which were not
    used; a shape that does not fit raises."""
    unexpected = model.load_state_dict(dict(partial), strict=False).unexpected_keys
    if unexpected:
        print(f"warm start: {len(unexpected)} checkpoint keys unused, e.g. {unexpected[:3]}")
    return unexpected


def _resize_bilinear_half_pixel(img: Tensor, h: int, w: int) -> Tensor:
    """Bilinear resize with half-pixel centers (jax.image.resize's), for
    upsampling; the edge samples are clamped."""
    ys = torch.clamp((torch.arange(h, dtype=torch.float64) + 0.5) * img.shape[0] / h - 0.5, 0, img.shape[0] - 1)
    xs = torch.clamp((torch.arange(w, dtype=torch.float64) + 0.5) * img.shape[1] / w - 0.5, 0, img.shape[1] - 1)
    y0, x0 = ys.floor().long(), xs.floor().long()
    y1 = torch.clamp(y0 + 1, max=img.shape[0] - 1)
    x1 = torch.clamp(x0 + 1, max=img.shape[1] - 1)
    wy, wx = (ys - y0)[:, None], (xs - x0)[None, :]
    return (
        img[y0][:, x0] * (1 - wy) * (1 - wx)
        + img[y0][:, x1] * (1 - wy) * wx
        + img[y1][:, x0] * wy * (1 - wx)
        + img[y1][:, x1] * wy * wx
    )


def resample_patch_embed_kernel(weight: Tensor, new_size: Tuple[int, int]) -> Tensor:
    """FlexiViT's pseudo-inverse resampling of a patch embedding
    (reference misc/weight_modify.py:13-86): the (out, in, nh, nw) conv
    weight whose responses on bilinearly resized patches match the old
    weight's on the originals. For a warm start at another patch size."""
    old_h, old_w = weight.shape[-2:]
    new_h, new_w = new_size
    if (old_h, old_w) == (new_h, new_w):
        return weight
    # The resize as a matrix on flattened patches: (new_h*new_w, old_h*old_w).
    basis = torch.eye(old_h * old_w, dtype=torch.float64).reshape(-1, old_h, old_w)
    resize = torch.stack([_resize_bilinear_half_pixel(e, new_h, new_w).reshape(-1) for e in basis], dim=1)
    # w_new = pinv(B^T) w_old, so that w_new^T (B x) ~= w_old^T x.
    w_old = weight.double().reshape(*weight.shape[:2], old_h * old_w)
    w_new = torch.einsum("nk,oik->oin", torch.linalg.pinv(resize.T), w_old)
    return w_new.reshape(*weight.shape[:2], new_h, new_w).to(weight.dtype)
