"""CroCo/DUSt3R ViT building blocks (counterpart of styl3r_tpu/models/vit.py;
reference `src/model/encoder/backbone/croco/blocks.py`).

Module and parameter names follow the reference's torch module tree, so a
state dict carries the reference's key names. LayerNorm eps is 1e-6, GELU is
the exact (erf) form and qkv has a bias.

VGGT's blocks (models/vggt.py) add two options that CroCo's leave off:
QK-norm (a LayerNorm over the head dim on q and on k, before RoPE; keys
`attn.q_norm`, `attn.k_norm`) and LayerScale (a learned per-channel gain on
each residual branch; keys `ls1.gamma`, `ls2.gamma`), and take the norms'
eps. With both off a block computes exactly what it did without them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from ..ops.attention import dot_product_attention
from ..ops.rope import rope2d_qk
from ..utils import trace


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    """x * gamma, a learned gain per channel (DINOv2's and VGGT's)."""

    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x: Tensor) -> Tensor:
        return x * self.gamma


class Attention(nn.Module):
    """Self-attention with optional RoPE2D on q/k. The head width is fixed at
    construction and `num_heads` counts the heads this module computes: all
    of them, or this rank's under tensor parallelism (parallel/tp.py), where
    qkv's rows hold [q | k | v] of those heads and proj takes their width.
    With `qk_norm`, q and k each pass a LayerNorm over the head dim (eps
    `eps`) before RoPE."""

    def __init__(self, dim: int, num_heads: int, rope_base: Optional[float] = None, qk_norm: bool = False,
                 eps: float = 1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.rope_base = rope_base
        self.qkv = nn.Linear(dim, dim * 3)
        if qk_norm:
            self.q_norm = nn.LayerNorm(self.head_dim, eps=eps)
            self.k_norm = nn.LayerNorm(self.head_dim, eps=eps)
        self.qk_norm = qk_norm
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: Tensor, pos: Optional[Tensor]) -> Tensor:
        b, n, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, self.head_dim).unbind(2)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if self.rope_base is not None:
            with trace.span("rope"):
                q, k = rope2d_qk(q, pos, k, pos, self.rope_base)
        out = dot_product_attention(q, k, v, scale=self.head_dim**-0.5)
        return self.proj(out.reshape(b, n, self.num_heads * self.head_dim))


class CrossAttention(nn.Module):
    """Cross-attention with optional RoPE2D on q/k; heads as in Attention."""

    def __init__(self, dim: int, num_heads: int, rope_base: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.rope_base = rope_base
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(
        self,
        query: Tensor,
        key: Tensor,
        value: Tensor,
        qpos: Optional[Tensor],
        kpos: Optional[Tensor],
    ) -> Tensor:
        b, nq, _ = query.shape
        heads, head_dim = self.num_heads, self.head_dim
        q = self.projq(query).reshape(b, nq, heads, head_dim)
        k = self.projk(key).reshape(b, key.shape[1], heads, head_dim)
        v = self.projv(value).reshape(b, value.shape[1], heads, head_dim)
        if self.rope_base is not None:
            with trace.span("rope"):
                q, k = rope2d_qk(q, qpos, k, kpos, self.rope_base)
        out = dot_product_attention(q, k, v, scale=head_dim**-0.5)
        return self.proj(out.reshape(b, nq, heads * head_dim))


class Block(nn.Module):
    """Pre-norm encoder block: x + attn(ln(x)), x + mlp(ln(x)); with
    `init_values`, each branch is scaled by a LayerScale (ls1, ls2) started
    at that value. `eps` is every LayerNorm's, QK-norm's too."""

    def __init__(
        self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
        rope_base: Optional[float] = None, qk_norm: bool = False,
        init_values: Optional[float] = None, eps: float = 1e-6,
    ):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads, rope_base, qk_norm=qk_norm, eps=eps)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self.layer_scale = init_values is not None
        if self.layer_scale:
            self.ls1 = LayerScale(dim, init_values)
            self.ls2 = LayerScale(dim, init_values)

    def forward(self, x: Tensor, pos: Optional[Tensor] = None) -> Tensor:
        if self.layer_scale:
            x = x + self.ls1(self.attn(self.norm1(x), pos))
            return x + self.ls2(self.mlp(self.norm2(x)))
        x = x + self.attn(self.norm1(x), pos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """Pre-norm decoder block: self-attn + cross-attn over the layer-normed
    memory y (norm_y) + MLP."""

    def __init__(
        self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
        rope_base: Optional[float] = None,
    ):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = Attention(dim, num_heads, rope_base)
        self.cross_attn = CrossAttention(dim, num_heads, rope_base)
        self.norm2 = layer_norm(dim)
        self.norm3 = layer_norm(dim)
        self.norm_y = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(
        self, x: Tensor, y: Tensor, xpos: Optional[Tensor], ypos: Optional[Tensor]
    ) -> Tuple[Tensor, Tensor]:
        x = x + self.attn(self.norm1(x), xpos)
        y_ = self.norm_y(y)
        x = x + self.cross_attn(self.norm2(x), y_, y_, xpos, ypos)
        x = x + self.mlp(self.norm3(x))
        return x, y


def token_grid_positions(h: int, w: int, device=None) -> Tensor:
    """Integer (y, x) positions of an h*w token grid, row-major, (h*w, 2)."""
    ys = torch.arange(h, dtype=torch.int32, device=device)
    xs = torch.arange(w, dtype=torch.int32, device=device)
    grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)
    return grid.reshape(h * w, 2)


class PatchEmbed(nn.Module):
    """p x p conv patchifier over NHWC images; returns tokens (b, n, dim) and
    their (y, x) positions (b, n, 2)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 1024):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        b, h, w, _ = images.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image size {(h, w)} not divisible by patch size {p}")
        x = self.proj(images.permute(0, 3, 1, 2))  # (b, dim, h/p, w/p)
        tokens = x.flatten(2).transpose(1, 2)
        pos = token_grid_positions(h // p, w // p, images.device)
        return tokens, pos[None].expand(b, -1, -1)


def random_token_mask(
    generator: torch.Generator, batch: int, num_tokens: int, mask_ratio: float, device=None
) -> Tensor:
    """CroCo's RandomMask (croco/masking.py:12-25): a bool (batch,
    num_tokens) mask with round(num_tokens * mask_ratio) True entries a row,
    the tokens of the lowest ranks of a uniform draw from `generator` (which
    lies on `device`). Kept for pretraining parity; no model here masks."""
    num_masked = int(round(num_tokens * mask_ratio))
    noise = torch.rand(batch, num_tokens, generator=generator, device=device)
    ranks = noise.argsort(dim=1).argsort(dim=1)
    return ranks < num_masked
