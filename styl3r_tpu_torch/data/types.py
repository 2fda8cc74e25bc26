"""Host-side data types (counterpart of styl3r_tpu/data/types.py; reference
`src/dataset/types.py:17-29`): numpy arrays, moved to the device a batch at
a time (models/styl3r.py::batch_to)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import numpy as np

Stage = Literal["train", "val", "test"]


@dataclass
class Views:
    extrinsics: np.ndarray  # (v, 4, 4) c2w
    intrinsics: np.ndarray  # (v, 3, 3) normalized
    image: np.ndarray  # (v, h, w, 3) float32 [0, 1]
    near: np.ndarray  # (v,)
    far: np.ndarray  # (v,)
    index: np.ndarray  # (v,) frame indices
    overlap: Optional[np.ndarray] = None


@dataclass
class Example:
    context: Views
    target: Views
    scene: str
    style_image: np.ndarray  # (hs, ws, 3) float32 [0, 1]
    style_name: str = ""
