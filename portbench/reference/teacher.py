"""[Frozen copy of styl3r_tpu_torch/models/distiller.py, the benchmark's reference: it
imports nothing of the program.]

Frozen DUSt3R/MASt3R teacher for pts3d distillation (counterpart of
styl3r_tpu/models/distiller.py; reference
`src/model/distiller/dust3d_backbone.py`).

A two-view asymmetric CroCo (the backbone's trunk without the intrinsics
token) with two confidence-predicting DPT pts3d heads: pseudo-GT point maps
for the Regr3D distillation loss (`model_wrapper_style.py:234-242`). Its
state-dict keys are a MASt3R/DUSt3R `model` dict's (`backbone.enc_blocks.0...`,
`downstream_head1.dpt...`).
"""

from __future__ import annotations

from typing import Dict

import torch.nn as nn
from torch import Tensor

from .croco import MultiViewCrocoBackbone
from .dpt import DPTPts3dHead


class Dust3RTeacher(nn.Module):
    """2-view backbone + a conf pts3d head per view. The trainer keeps it
    frozen (`freeze()`: eval mode, no gradients) and f32."""

    def __init__(
        self,
        patch_size: int = 16,
        enc_depth: int = 24,
        dec_depth: int = 12,
        enc_dim: int = 1024,
        dec_dim: int = 768,
        enc_heads: int = 16,
        dec_heads: int = 12,
        head_feature_dim: int = 256,
        head_last_dim: int = 128,
        head_layer_dims: tuple = (96, 192, 384, 768),
    ):
        super().__init__()
        self.backbone = MultiViewCrocoBackbone(
            patch_size=patch_size, use_intrinsics_token=False, enc_depth=enc_depth, dec_depth=dec_depth,
            enc_dim=enc_dim, dec_dim=dec_dim, enc_heads=enc_heads, dec_heads=dec_heads,
        )
        l2 = dec_depth
        head_kwargs = dict(
            hook_dims=(enc_dim, dec_dim, dec_dim, dec_dim),
            hooks=(0, l2 * 2 // 4, l2 * 3 // 4, l2),
            feature_dim=head_feature_dim,
            last_dim=head_last_dim,
            layer_dims=head_layer_dims,
            patch_size=patch_size,
            with_conf=True,
        )
        self.downstream_head1 = DPTPts3dHead(**head_kwargs)
        self.downstream_head2 = DPTPts3dHead(**head_kwargs)

    def freeze(self) -> "Dust3RTeacher":
        return self.eval().requires_grad_(False)

    def forward(self, images: Tensor) -> Dict[str, Tensor]:
        """images: (b, 2, h, w, 3) in [-1, 1]. Returns each view's pts3d (b,
        h, w, 3) and conf (b, h, w), in view 1's frame as DUSt3R gives them."""
        h, w = images.shape[2:4]
        _, _, dec_feat = self.backbone(images, None)
        pts1, conf1 = self.downstream_head1([t[:, 0].float() for t in dec_feat], (h, w))
        pts2, conf2 = self.downstream_head2([t[:, 1].float() for t in dec_feat], (h, w))
        return {"pts3d_1": pts1, "conf_1": conf1, "pts3d_2": pts2, "conf_2": conf2}
