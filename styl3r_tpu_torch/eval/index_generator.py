"""Evaluation index generation (counterpart of
styl3r_tpu/eval/index_generator.py; reference
`src/evaluation/evaluation_index_generator.py`): for each scene, a
deterministic context pair whose view overlap falls in a band, plus evenly
spaced targets between them, in the `assets/evaluation_index_*.json` format
({scene: {context, target, overlap} or null}).

Overlap is geometric (no model needed): the share of view A's probe rays,
at a few depths, that land inside view B. The pairs are drawn from a numpy
Generator in the JAX package's order, so one seed gives the same index.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..geometry.projection import get_world_rays, project, sample_image_grid
from .metrics import overlap_tag


def view_overlap(
    ext_a: np.ndarray, ext_b: np.ndarray, k_a: np.ndarray, k_b: np.ndarray,
    probe_depths: Sequence[float] = (0.5, 1.0, 2.0, 4.0),
    grid: int = 8,
) -> float:
    """The share of view A's grid x grid probe points, at each probe depth,
    that view B sees (in front, inside [0, 1]^2), averaged over the depths;
    computed in f32 on the CPU."""

    def tensor(x):
        return torch.tensor(np.asarray(x, np.float32))

    coords, _ = sample_image_grid((grid, grid))
    origins, dirs = get_world_rays(coords, tensor(ext_a), tensor(k_a))
    total = 0.0
    for d in probe_depths:
        xy, in_front = project(origins + dirs * d, tensor(ext_b), tensor(k_b))
        inside = in_front & (xy[..., 0] >= 0) & (xy[..., 0] <= 1) & (xy[..., 1] >= 0) & (xy[..., 1] <= 1)
        total += float(inside.float().mean())
    return total / len(probe_depths)


def generate_scene_entry(
    extrinsics: np.ndarray,
    intrinsics: np.ndarray,
    num_targets: int = 3,
    min_overlap: float = 0.25,
    max_overlap: float = 0.75,
    min_gap: int = 30,
    max_gap: int = 120,
    rng: Optional[np.random.Generator] = None,
) -> Optional[Dict]:
    """Pick a context pair in the overlap band; None if the scene has none."""
    rng = rng or np.random.default_rng(0)
    n = len(extrinsics)
    gaps = [g for g in range(min_gap, min(max_gap, n - 1) + 1, max(1, (max_gap - min_gap) // 8))]
    for gap in gaps:
        for _ in range(4):
            left = int(rng.integers(0, n - gap))
            right = left + gap
            ov = view_overlap(extrinsics[left], extrinsics[right], intrinsics[left], intrinsics[right])
            if min_overlap <= ov <= max_overlap:
                targets = np.linspace(left, right, num_targets + 2)[1:-1]
                return {
                    "context": [left, right],
                    "target": [int(t) for t in targets.round()],
                    "overlap": overlap_tag(ov),
                }
    return None


def generate_evaluation_index(
    scenes: Dict[str, Dict],
    output_path: Path,
    seed: int = 0,
    **kwargs,
) -> Dict:
    """scenes: {key: {'extrinsics': (n,4,4), 'intrinsics': (n,3,3)}} ->
    writes + returns the evaluation index."""
    rng = np.random.default_rng(seed)
    index = {}
    for key, data in scenes.items():
        index[key] = generate_scene_entry(
            np.asarray(data["extrinsics"]), np.asarray(data["intrinsics"]),
            rng=rng, **kwargs,
        )
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with output_path.open("w") as f:
        json.dump(index, f)
    return index
