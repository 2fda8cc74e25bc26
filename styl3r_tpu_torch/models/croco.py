"""CroCo ViT-L encoder stacks: the multiview geometry backbone, the
encoder-only backbone, the token stylizer and the 2-view structure builder
(counterpart of styl3r_tpu/models/croco.py; reference
`backbone_croco_multiview.py`, `backbone_croco_enc.py`, `token_stylizer.py`
and `structure_builder.py`).

The encoder stacks hold their encoder's `patch_embed`, `enc_blocks` and
`enc_norm` directly, as the reference modules do, so their state-dict keys
are the reference's (`backbone.enc_blocks.N.attn.qkv.weight`, ...).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
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

_constants: Dict[tuple, Tensor] = {}


def _constant(key: tuple, make: Callable[[], Tensor]) -> Tensor:
    """make()'s small index tensor, kept under `key` (which names its
    device). make() builds it with kernels on the device, never from a host
    list, so the forward has no host copy to wait for and a CUDA graph can
    capture it. It is built outside inference mode, so that a training
    forward may save it for backward, and not kept while a graph is being
    captured, since its memory would then be the graph's."""
    t = _constants.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = make()
        if not (t.is_cuda and torch.cuda.is_current_stream_capturing()):
            _constants[key] = t
    return t


def ctx_view_index(v: int, device) -> Tensor:
    """(v, v-1) int64: row i lists every view but i, in view order."""

    def make():
        others = torch.arange(v - 1, device=device)
        return others + (others >= torch.arange(v, device=device)[:, None])

    return _constant(("ctx_views", v, torch.device(device)), make)


def generate_ctx_views(x: Tensor) -> Tensor:
    """(b, v, l, c) -> (b, v, (v-1)*l, c): for each view, the concat of every
    other view's tokens, in view order."""
    b, v, l, c = x.shape
    return x[:, ctx_view_index(v, x.device)].reshape(b, v, (v - 1) * l, c)


def extra_token_pos(n_h: int, dtype: torch.dtype, device) -> Tensor:
    """(1, 2) [[n_h, 0]]: the grid position of an appended extra token."""

    def make():
        return F.pad(torch.full((1, 1), n_h, dtype=dtype, device=device), (0, 1))

    return _constant(("extra_pos", n_h, dtype, torch.device(device)), make)


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
            extra_pos = extra_token_pos(n_h, pos.dtype, pos.device)
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


class CrocoEncBackbone(CrocoVitEncoder):
    """Encoder-only CroCo backbone (reference AsymmetricCroCoEnc,
    backbone_croco_enc.py:61-226): the shared encoder runs on each view with
    the optional intrinsics token; no cross-view decoder. Returns (feat,
    pos), (b, v, l, enc_dim) and (b, v, l, 2), with the intrinsics token
    kept (the callers trim it)."""

    def __init__(
        self, patch_size: int = 16, use_intrinsics_token: bool = True,
        enc_depth: int = ENC_DEPTH, enc_dim: int = ENC_DIM, enc_heads: int = ENC_HEADS,
    ):
        super().__init__(enc_depth, enc_dim, enc_heads, patch_size)
        self.use_intrinsics_token = use_intrinsics_token
        if use_intrinsics_token:
            self.intrinsic_encoder = nn.Linear(9, enc_dim)

    def forward(self, images: Tensor, intrinsics: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        b, v, h, w, _ = images.shape
        extra = None
        if self.use_intrinsics_token:
            if intrinsics is None:
                raise ValueError("backbone configured with intrinsics token; pass intrinsics")
            extra = self.intrinsic_encoder(intrinsics.reshape(b * v, 9).to(self.dtype))[:, None]
        feat, pos = self.encode(images.reshape(b * v, h, w, 3), extra)
        l = feat.shape[1]
        return feat.reshape(b, v, l, self.enc_dim), pos.reshape(b, v, l, 2)


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


class StructureBuilder(nn.Module):
    """The structure branch of the 2-view token-style encoder (reference
    structure_builder.py:36-142): both views' encoder tokens, projected to
    the decoder width, go through RoPE self-attention blocks over their
    concatenation. Returns the (dec_depth + 1)-level per-view pyramid
    [encoder tokens, block outputs (the last normed)], each (b, 2, l-1, c)
    with the trailing intrinsics token trimmed."""

    def __init__(
        self, enc_dim: int = ENC_DIM, dec_dim: int = DEC_DIM, dec_depth: int = DEC_DEPTH,
        dec_heads: int = DEC_HEADS,
    ):
        super().__init__()
        self.dec_dim = dec_dim
        self.decoder_embed = nn.Linear(enc_dim, dec_dim)
        self.dec_blocks = nn.ModuleList(
            [Block(dec_dim, dec_heads, rope_base=ROPE_BASE) for _ in range(dec_depth)]
        )
        self.dec_norm = layer_norm(dec_dim)

    def forward(self, feats: Tensor, pos: Tensor) -> List[Tensor]:
        """feats: (b, 2, l, enc_dim); pos: (b, 2, l, 2)."""
        b, v, l, _ = feats.shape
        d = self.dec_dim
        outputs: List[Tensor] = [feats]
        x = self.decoder_embed(feats).reshape(b, v * l, d)
        xpos = pos.reshape(b, v * l, 2)
        for blk in self.dec_blocks:
            x = blk(x, xpos)
            outputs.append(x.reshape(b, v, l, d))
        outputs[-1] = self.dec_norm(x).reshape(b, v, l, d)
        return [t[:, :, :-1] for t in outputs]
