"""Attention primitive for the ViT stack (counterpart of
styl3r_tpu/ops/attention.py, which leaves it to XLA)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor


def dot_product_attention(q: Tensor, k: Tensor, v: Tensor, scale: Optional[float] = None) -> Tensor:
    """softmax(q kᵀ · scale) v over (batch, seq, heads, head_dim) tensors,
    the JAX layout. This is the one place the port moves heads before the
    sequence, for scaled_dot_product_attention, and back.

    CUDA tensors may take only SDPA's fused backends (flash,
    memory-efficient, cuDNN), in SDPA's own order: the math backend is off
    for the call, so where no fused backend takes it, it raises, where the
    math backend would have materialised the (seq, seq) scores of every
    head (35.5 GB at VGGT's 33,312 tokens). The flag is switched directly:
    `torch.nn.attention.sdpa_kernel` costs ~40 µs of host time a call on
    the H100's host, ~2 µs this way. CPU tensors take any backend."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if not q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v, scale=scale).transpose(1, 2)
    math_on = torch.backends.cuda.math_sdp_enabled()
    torch.backends.cuda.enable_math_sdp(False)
    try:
        out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    finally:
        torch.backends.cuda.enable_math_sdp(math_on)
    return out.transpose(1, 2)
