"""The one traffic generator: scenes drawn from the run's seed on the host
(the measurement scene of styl3r_tpu_torch/bench/batch.py). A scene is v
context views of uniform noise at size x size, a style image of uniform
noise, and t target cameras: the first at context view 0's camera, the
others 0.2 along x; every camera has the normalized intrinsics K, near 1
and far 100. Scene k of a run is drawn from the seed and k alone, so every
seed gives the same sizes in another content."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

K = np.asarray([[1.1, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1.0]], np.float32)


def draw(seed: int, index: int, traffic: Dict[str, int]) -> Tuple[np.ndarray, ...]:
    """Batch-ordered float32 arrays of `traffic["batch"]` scenes: context
    images (b, v, h, w, 3), context intrinsics, target extrinsics (b, t, 4,
    4), target intrinsics, near (b, t), far (b, t), style image (b, hs, ws,
    3) and, with `traffic["target_images"]`, target images (b, t, h, w, 3)."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, index])
    b, v, t = traffic["batch"], traffic["views"], traffic["targets"]
    h = w = traffic["size"]
    hs = traffic.get("style_size", h)
    ext = np.broadcast_to(np.eye(4, dtype=np.float32), (b, t, 4, 4)).copy()
    ext[:, 1:, 0, 3] = 0.2
    context = rng.random((b, v, h, w, 3), dtype=np.float32)
    style = rng.random((b, hs, hs, 3), dtype=np.float32)
    targets = rng.random((b, t, h, w, 3), dtype=np.float32) if traffic.get("target_images") else None
    return (
        context,
        np.array(np.broadcast_to(K, (b, v, 3, 3))),
        ext,
        np.array(np.broadcast_to(K, (b, t, 3, 3))),
        np.full((b, t), 1.0, np.float32),
        np.full((b, t), 100.0, np.float32),
        style,
        targets,
    )


def pool(seed: int, traffic: Dict[str, int]) -> List[Tuple[np.ndarray, ...]]:
    """`traffic["pool"]` scenes (batches) drawn up front; a serving run
    cycles through them, so every request hands over its own host arrays."""
    return [draw(seed, k, traffic) for k in range(traffic["pool"])]


def step_generator(seed: int, step: int, device) -> "torch.Generator":
    """The dropout generator of training step `step` of a run, a function
    of the seed and the step alone (the rule of train/trainer.py's
    step_generator)."""
    import torch

    words = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, step]).generate_state(2)
    return torch.Generator(device).manual_seed(int(words[0]) << 32 | int(words[1]))
