"""Reading the reference's torch checkpoints into the port's model
(counterpart of the torch-checkpoint part of styl3r_tpu/utils/checkpoint.py).

The port's modules carry the reference's Lightning key names
(`encoder.backbone.enc_blocks.0...`), so a released .ckpt/.pth loads by key.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch
import torch.nn as nn

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


def load_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Load a torch checkpoint into `model` by key. The unused
    refinenet4.resConfUnit1 entries are dropped; any other missing or
    unexpected key raises."""
    if Path(path).is_dir():
        raise ValueError(
            f"{path} is a directory: orbax checkpoints are not read by the port yet (they wait for "
            "the training runtime's checkpoint format); pass a torch .ckpt or .pth"
        )
    sd = {k: v for k, v in load_torch_state_dict(path).items() if UNUSED_KEY not in k}
    model.load_state_dict(sd, strict=True)
    return model
