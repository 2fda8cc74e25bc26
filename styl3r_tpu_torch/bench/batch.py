"""The measurement scene (counterpart of __graft_entry__._example_batch)."""

from __future__ import annotations

import numpy as np

from ..device import DeviceLike
from ..models.styl3r import Batch, batch_to

# Normalized intrinsics of every context and target camera.
K = np.asarray([[1.1, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1.0]], np.float32)


def example_batch(
    rng: np.random.Generator, b: int, v: int, h: int, w: int, t: int, style_hw: int,
    device: DeviceLike, targets: bool = True,
) -> Batch:
    """b scenes of v context views (uniform noise from `rng`) and a style
    image, with t targets: the first at context view 0's camera, the others
    0.2 along x. The draws are JAX's, in its order (context images, style
    image, target images), so the same `rng` gives the same f32 arrays.
    Without `targets` the target images are drawn and dropped, so later
    draws from `rng` stay JAX's too."""
    ext = np.broadcast_to(np.eye(4, dtype=np.float32), (b, t, 4, 4)).copy()
    ext[:, 1:, 0, 3] = 0.2
    context = rng.uniform(0, 1, (b, v, h, w, 3))
    style = rng.uniform(0, 1, (b, style_hw, style_hw, 3))
    target_images = rng.uniform(0, 1, (b, t, h, w, 3))
    return batch_to(Batch(
        context_images=context,
        context_intrinsics=np.broadcast_to(K, (b, v, 3, 3)),
        target_extrinsics=ext,
        target_intrinsics=np.broadcast_to(K, (b, t, 3, 3)),
        target_near=np.full((b, t), 1.0),
        target_far=np.full((b, t), 100.0),
        style_image=style,
        target_images=target_images if targets else None,
    ), device)
