"""The name -> module factories of the reference (counterpart of
styl3r_tpu/models/registry.py; reference `src/model/encoder/__init__.py`,
`backbone/__init__.py`, `decoder/__init__.py`, `distiller`).

Names map to the port's modules under the JAX registry's names; an unknown
name raises ValueError.
"""

from __future__ import annotations

from functools import partial


def get_backbone(name: str, **kwargs):
    from .croco import CrocoEncBackbone, MultiViewCrocoBackbone

    if name in ("croco", "croco_multi"):
        # The multiview backbone at v=2 is the asymmetric two-view model
        # (view 0 through dec_blocks, view 1 through dec_blocks2).
        return MultiViewCrocoBackbone(**kwargs)
    if name == "croco_enc":
        return CrocoEncBackbone(**kwargs)
    if name == "resnet":
        from .backbones import BackboneResnet

        return BackboneResnet(**kwargs)
    if name == "dino":
        from .backbones import BackboneDino

        return BackboneDino(**kwargs)
    raise ValueError(f"unknown backbone: {name}")


def get_head(name: str, out_channels: int = 3, **kwargs):
    """'dpt' pts3d, 'dpt_gs' / 'dpt_gs_sh' Gaussian-parameter towers,
    'linear' / 'linear_gs' pixel-shuffle heads (reference heads/__init__.py
    head_factory)."""
    from .dpt import DPTGSHead, DPTGSSHHead, DPTPts3dHead, LinearGSHead, LinearPts3dHead

    if name == "dpt":
        return DPTPts3dHead(**kwargs)
    if name == "dpt_gs":
        return DPTGSHead(out_channels=out_channels, **kwargs)
    if name == "dpt_gs_sh":
        return DPTGSSHHead(out_channels=out_channels, **kwargs)
    if name == "linear":
        return LinearPts3dHead(**kwargs)
    if name == "linear_gs":
        return LinearGSHead(out_channels=out_channels, **kwargs)
    raise ValueError(f"unknown head: {name}")


def get_encoder(name: str, **kwargs):
    from .encoder import NoPoSplatMultiEncoder, Styl3rEncoder, Styl3rTokenStyleEncoder2View

    if name == "noposplat_multi_token_style":
        return Styl3rEncoder(**kwargs)
    if name == "noposplat_token_style":
        return Styl3rTokenStyleEncoder2View(**kwargs)
    if name in ("noposplat", "noposplat_multi"):
        return NoPoSplatMultiEncoder(**kwargs)
    raise ValueError(f"unknown encoder: {name}")


def get_decoder(name: str = "splatting", **kwargs):
    from .decoder import render_gaussians

    if name in ("splatting", "splatting_cuda"):
        return partial(render_gaussians, **kwargs)
    raise ValueError(f"unknown decoder: {name}")


def get_distiller(name: str = "dust3r", **kwargs):
    from .distiller import Dust3RTeacher

    if name in ("dust3r", "mast3r"):
        return Dust3RTeacher(**kwargs)
    raise ValueError(f"unknown distiller: {name}")


def get_model(name: str, **kwargs):
    """A whole model by name: 'vggt' (models/vggt.py; VGGT-1B's published
    widths unless `kwargs` give others)."""
    if name == "vggt":
        from .vggt import VGGT

        return VGGT(**kwargs)
    raise ValueError(f"unknown model: {name}")
