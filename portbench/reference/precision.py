"""[Frozen copy of styl3r_tpu_torch/models/precision.py, the benchmark's reference: it
imports nothing of the program.]

Compute dtypes apart from storage dtypes, as flax's `dtype=` has them.

In the JAX package `backbone_dtype` and `head_trunk_dtype` set the type a
module computes in; its parameters stay f32 and are cast at use. The port
trains the same way: its weights stay f32 (AdamW's small early updates would
vanish in bf16 storage) and `compute_in` casts them at use with
torch.autocast. Serving may store the weights in the compute dtype instead
(`Styl3rModel.cast_dtypes`); the compute then needs no autocast at all.
"""

from __future__ import annotations

from typing import Optional

import torch


def compute_in(
    dtype: Optional[torch.dtype], weight_dtype: torch.dtype, device_type: str
) -> torch.autocast:
    """A context that runs matmuls and convolutions in `dtype` on weights
    stored in `weight_dtype`: autocast where the two differ, nothing where
    they agree or `dtype` is None."""
    enabled = dtype is not None and dtype != weight_dtype
    return torch.autocast(device_type, dtype=dtype if enabled else torch.bfloat16, enabled=enabled)
