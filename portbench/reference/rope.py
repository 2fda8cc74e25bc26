"""[Frozen copy of styl3r_tpu_torch/ops/rope.py, the benchmark's reference: it
imports nothing of the program.]

2D rotary position embeddings (counterpart of styl3r_tpu/ops/rope.py;
reference `src/model/encoder/backbone/croco/pos_embed.py:112-159`).

The head dim D splits into a Y half and an X half; each half of size F gets
1D RoPE with inv_freq[f] = 1 / base**(2f/F), the cos/sin vector is
cat(freqs, freqs) and rotate_half maps (x1, x2) -> (-x2, x1). Positions are
integer (y, x) token-grid coordinates.
"""

from __future__ import annotations

import torch
from torch import Tensor


def _rope1d(tokens: Tensor, pos: Tensor, base: float) -> Tensor:
    """1D RoPE over (..., n, h, f) tokens with integer positions (..., n)."""
    f = tokens.shape[-1]
    half = f // 2
    exponent = torch.arange(0, f, 2, dtype=torch.float32, device=tokens.device) / f
    inv_freq = 1.0 / (base**exponent)
    angles = pos.to(torch.float32)[..., None] * inv_freq  # (..., n, f/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cat([cos, cos], dim=-1).to(tokens.dtype)
    sin = torch.cat([sin, sin], dim=-1).to(tokens.dtype)
    x1, x2 = tokens[..., :half], tokens[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return tokens * cos + rotated * sin


def apply_rope2d(tokens: Tensor, positions: Tensor, base: float = 100.0) -> Tensor:
    """Rotate (..., n, heads, d) q/k tokens by their (..., n, 2) integer
    (y, x) grid positions; d % 4 == 0."""
    d = tokens.shape[-1]
    y_out = _rope1d(tokens[..., : d // 2], positions[..., 0], base)
    x_out = _rope1d(tokens[..., d // 2 :], positions[..., 1], base)
    return torch.cat([y_out, x_out], dim=-1)
