"""Device selection for the port's entry points."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another device by name; under torchrun (LOCAL_RANK in the environment)
    the card LOCAL_RANK. Never falls back to the CPU: with no device given
    and no CUDA present, this raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "styl3r_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU explicitly"
            )
        local_rank = os.environ.get("LOCAL_RANK")
        return torch.device("cuda", int(local_rank)) if local_rank is not None else torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
