"""[Frozen copy of styl3r_tpu_torch/ops/attention.py, the benchmark's reference: it
imports nothing of the program.]

Attention primitive for the ViT stack (counterpart of
styl3r_tpu/ops/attention.py, which leaves it to XLA)."""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F
from torch import Tensor


def dot_product_attention(
    q: Tensor, k: Tensor, v: Tensor, scale: Optional[float] = None
) -> Tensor:
    """softmax(q kᵀ · scale) v over (batch, seq, heads, head_dim) tensors,
    the JAX layout. This is the one place the port moves heads before the
    sequence, for scaled_dot_product_attention, and back."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale
    )
    return out.transpose(1, 2)
