"""[Frozen copy of styl3r_tpu_torch/models/croco.py, the benchmark's reference: it
imports nothing of the program.]

CroCo ViT-L encoder stacks: the multiview geometry backbone and the token
stylizer (counterpart of styl3r_tpu/models/croco.py; reference
`backbone_croco_multiview.py` and `token_stylizer.py`).

The encoder stacks hold their encoder's `patch_embed`, `enc_blocks` and
`enc_norm` directly, as the reference modules do, so their state-dict keys
are the reference's (`backbone.enc_blocks.N.attn.qkv.weight`, ...).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
from torch import Tensor

from .vit import Block, DecoderBlock, PatchEmbed, layer_norm

# ViT-L encoder / Base decoder (reference croco_params['ViTLarge_BaseDecoder']).
ENC_DEPTH = 24
DEC_DEPTH = 12
ENC_DIM = 1024
DEC_DIM = 768
ENC_HEADS = 16
DEC_HEADS = 12
ROPE_BASE = 100.0


def generate_ctx_views(x: Tensor) -> Tensor:
    """(b, v, l, c) -> (b, v, (v-1)*l, c): for each view, the concat of every
    other view's tokens, in view order."""
    b, v, l, c = x.shape
    idx = torch.tensor(
        [[j for j in range(v) if j != i] for i in range(v)], device=x.device
    )
    return x[:, idx].reshape(b, v, (v - 1) * l, c)


class CrocoVitEncoder(nn.Module):
    """Patch embed + RoPE2D self-attention blocks + final norm."""

    def __init__(
        self, depth: int = ENC_DEPTH, dim: int = ENC_DIM, num_heads: int = ENC_HEADS,
        patch_size: int = 16,
    ):
        super().__init__()
        self.patch_size = patch_size
        self.enc_dim = dim
        self.patch_embed = PatchEmbed(patch_size, dim)
        self.enc_blocks = nn.ModuleList(
            [Block(dim, num_heads, rope_base=ROPE_BASE) for _ in range(depth)]
        )
        self.enc_norm = layer_norm(dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.enc_norm.weight.dtype

    def encode(
        self, images: Tensor, extra_token: Optional[Tensor] = None
    ) -> Tuple[Tensor, Tensor]:
        """images: (n, h, w, 3). extra_token: optional (n, 1, dim) token
        appended at the synthetic grid position (h/p, 0)."""
        x, pos = self.patch_embed(images.to(self.dtype))
        if extra_token is not None:
            n_h = images.shape[1] // self.patch_size
            x = torch.cat([x, extra_token.to(x.dtype)], dim=1)
            extra_pos = torch.tensor([[n_h, 0]], dtype=pos.dtype, device=pos.device)
            pos = torch.cat([pos, extra_pos[None].expand(x.shape[0], 1, 2)], dim=1)
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return self.enc_norm(x), pos

    def forward(self, images: Tensor, extra_token: Optional[Tensor] = None):
        return self.encode(images, extra_token)


class MultiViewCrocoBackbone(CrocoVitEncoder):
    """Shared encoder over V views + dual decoder stacks: view 0 cross-attends
    (dec_blocks) to all other views' tokens, views 1.. (dec_blocks2) to their
    complements.

    Returns (enc_feat, enc_pos, dec_feats): dec_feats is the 13-level pyramid
    [encoder tokens, 12 decoder outputs (last normed)], each (b, v, l, c)
    with the intrinsics token trimmed; enc_feat/enc_pos keep it.
    """

    def __init__(
        self, patch_size: int = 16, use_intrinsics_token: bool = True,
        enc_depth: int = ENC_DEPTH, dec_depth: int = DEC_DEPTH,
        enc_dim: int = ENC_DIM, dec_dim: int = DEC_DIM,
        enc_heads: int = ENC_HEADS, dec_heads: int = DEC_HEADS,
    ):
        super().__init__(enc_depth, enc_dim, enc_heads, patch_size)
        self.use_intrinsics_token = use_intrinsics_token
        self.dec_dim = dec_dim
        if use_intrinsics_token:
            self.intrinsic_encoder = nn.Linear(9, enc_dim)
        self.decoder_embed = nn.Linear(enc_dim, dec_dim)
        self.dec_blocks = nn.ModuleList(
            [DecoderBlock(dec_dim, dec_heads, rope_base=ROPE_BASE) for _ in range(dec_depth)]
        )
        self.dec_blocks2 = nn.ModuleList(
            [DecoderBlock(dec_dim, dec_heads, rope_base=ROPE_BASE) for _ in range(dec_depth)]
        )
        self.dec_norm = layer_norm(dec_dim)

    def forward(
        self, images: Tensor, intrinsics: Optional[Tensor] = None
    ) -> Tuple[Tensor, Tensor, List[Tensor]]:
        """images: (b, v, h, w, 3) in [-1, 1]; intrinsics: (b, v, 3, 3)."""
        b, v, h, w, _ = images.shape
        extra = None
        if self.use_intrinsics_token:
            if intrinsics is None:
                raise ValueError("backbone configured with intrinsics token; pass intrinsics")
            extra = self.intrinsic_encoder(intrinsics.reshape(b * v, 9).to(self.dtype))[:, None]
        feat, pos = self.encode(images.reshape(b * v, h, w, 3), extra)
        l = feat.shape[1]
        feat = feat.reshape(b, v, l, self.enc_dim)
        pos = pos.reshape(b, v, l, 2)
        dec_feats = self._decode(feat, pos)
        if self.use_intrinsics_token:
            dec_feats = [t[:, :, :-1] for t in dec_feats]
        return feat, pos, dec_feats

    def _decode(self, feat: Tensor, pos: Tensor) -> List[Tensor]:
        b, v, l, _ = feat.shape
        d = self.dec_dim
        outputs: List[Tensor] = [feat]
        x = self.decoder_embed(feat)
        pos_ctx = generate_ctx_views(pos)
        pos0, posr = pos[:, 0], pos[:, 1:].reshape(b * (v - 1), l, 2)
        pos_ctx0 = pos_ctx[:, 0]
        pos_ctxr = pos_ctx[:, 1:].reshape(b * (v - 1), (v - 1) * l, 2)
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            ctx = generate_ctx_views(x)
            f0, _ = blk1(x[:, 0], ctx[:, 0], pos0, pos_ctx0)
            fr, _ = blk2(
                x[:, 1:].reshape(b * (v - 1), l, d),
                ctx[:, 1:].reshape(b * (v - 1), (v - 1) * l, d),
                posr,
                pos_ctxr,
            )
            x = torch.cat([f0[:, None], fr.reshape(b, v - 1, l, d)], dim=1)
            outputs.append(x)
        outputs[-1] = self.dec_norm(outputs[-1])
        return outputs


class TokenStylizer(CrocoVitEncoder):
    """Style-image encoder + cross-attention decoder blocks where the
    flattened content tokens of all views query the style tokens. Receives
    the backbone's untrimmed enc_feat/enc_pos and returns the 13-level
    pyramid (b, v, l-1, c) with the intrinsics token trimmed."""

    def __init__(
        self, patch_size: int = 16,
        enc_depth: int = ENC_DEPTH, dec_depth: int = DEC_DEPTH,
        enc_dim: int = ENC_DIM, dec_dim: int = DEC_DIM,
        enc_heads: int = ENC_HEADS, dec_heads: int = DEC_HEADS,
    ):
        super().__init__(enc_depth, enc_dim, enc_heads, patch_size)
        self.dec_dim = dec_dim
        self.decoder_embed = nn.Linear(enc_dim, dec_dim)
        self.dec_blocks = nn.ModuleList(
            [DecoderBlock(dec_dim, dec_heads, rope_base=ROPE_BASE) for _ in range(dec_depth)]
        )
        self.dec_norm = layer_norm(dec_dim)

    def forward(
        self, style_image: Tensor, content_feat: Tensor, content_pos: Tensor
    ) -> List[Tensor]:
        """style_image: (b, hs, ws, 3); content_feat/pos: (b, v, l, enc_dim) /
        (b, v, l, 2)."""
        b, v, l, _ = content_feat.shape
        d = self.dec_dim
        style_feat, style_pos = self.encode(style_image)
        outputs: List[Tensor] = [content_feat]
        x = self.decoder_embed(content_feat.reshape(b, v * l, self.enc_dim).to(self.dtype))
        xpos = content_pos.reshape(b, v * l, 2)
        y = self.decoder_embed(style_feat)
        for blk in self.dec_blocks:
            x, _ = blk(x, y, xpos, style_pos)
            outputs.append(x.reshape(b, v, l, d))
        outputs[-1] = self.dec_norm(x).reshape(b, v, l, d)
        return [t[:, :, :-1] for t in outputs]
