"""Context/target view samplers (counterpart of
styl3r_tpu/data/view_samplers.py; reference `src/dataset/view_sampler/`).

  * bounded: a curriculum on the gap between the outer context frames,
    targets drawn between them, extra context views drawn inside
    (view_sampler_bounded.py:24-138);
  * evaluation: fixed per-scene indices from an evaluation index JSON
    (view_sampler_evaluation.py:26-80);
  * arbitrary: uniform random; all: every frame is context and target.

Each sampler draws from the numpy Generator it is given, in the JAX
package's order, so one seed yields the same views in both packages. The
curriculum sees the training step as a plain int.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import numpy as np


@dataclass
class SampledViews:
    context: np.ndarray  # (v,) int indices
    target: np.ndarray  # (t,) int indices
    overlap: float = 0.5


class ViewSamplerBounded:
    def __init__(
        self,
        num_context_views: int = 2,
        num_target_views: int = 4,
        min_gap: int = 45,
        max_gap: int = 90,
        min_distance_to_context: int = 0,
        warm_up_steps: int = 0,
        initial_min_gap: int = 25,
        initial_max_gap: int = 25,
        stage: str = "train",
    ):
        self.num_context_views = num_context_views
        self.num_target_views = num_target_views
        self.min_gap = min_gap
        self.max_gap = max_gap
        self.min_distance_to_context = min_distance_to_context
        self.warm_up_steps = warm_up_steps
        self.initial_min_gap = initial_min_gap
        self.initial_max_gap = initial_max_gap
        self.stage = stage

    def _schedule(self, initial: int, final: int, step: int) -> int:
        if self.warm_up_steps <= 0:
            return final
        fraction = step / self.warm_up_steps
        return min(initial + int((final - initial) * fraction), final)

    def sample(
        self, scene: str, num_views: int, rng: np.random.Generator, global_step: int = 0
    ) -> SampledViews:
        if self.stage == "test":
            min_gap = max_gap = self.max_gap
        else:
            min_gap = self._schedule(self.initial_min_gap, self.min_gap, global_step)
            max_gap = self._schedule(self.initial_max_gap, self.max_gap, global_step)

        max_gap = min(num_views - 1, max_gap)
        min_gap = max(2 * self.min_distance_to_context, min_gap)
        if max_gap < min_gap:
            raise ValueError("Example does not have enough frames!")
        gap = int(rng.integers(min_gap, max_gap + 1))

        left = int(rng.integers(num_views - gap))
        if self.stage == "test":
            left = 0
        right = left + gap

        if self.stage == "test":
            target = np.arange(left, right + 1)
        else:
            target = rng.integers(
                left + self.min_distance_to_context,
                right + 1 - self.min_distance_to_context,
                size=self.num_target_views,
            )

        extra = []
        if self.num_context_views > 2:
            need = self.num_context_views - 2
            while len(set(extra)) != need:
                extra = rng.integers(left + 1, right, size=need).tolist()

        context = np.asarray([left, *extra, right], dtype=np.int64)
        return SampledViews(context=context, target=np.asarray(target, np.int64))


class ViewSamplerEvaluation:
    """Fixed indices from assets/evaluation_index_*.json:
    {scene: {context: [...], target: [...], overlap: str} | null}."""

    def __init__(self, index_path: Path, num_context_views: int = 2):
        with Path(index_path).open() as f:
            self.index: Dict = json.load(f)
        self.num_context_views = num_context_views

    def sample(self, scene: str, num_views: int, rng=None, global_step: int = 0) -> SampledViews:
        entry = self.index.get(scene)
        if entry is None:
            raise ValueError(f"scene {scene} has no evaluation entry")
        context = np.asarray(entry["context"], np.int64)
        if self.num_context_views > len(context):
            # The 2 -> N context upsample (additional_view_hack.py:6-18):
            # evenly spaced views between the two outer ones.
            left, right = int(context[0]), int(context[-1])
            context = np.linspace(left, right, self.num_context_views).round().astype(np.int64)
        overlap_tag = entry.get("overlap", 0.5)
        overlap = {"small": 0.15, "medium": 0.5, "large": 0.85}.get(overlap_tag, 0.5)
        return SampledViews(context=context, target=np.asarray(entry["target"], np.int64), overlap=overlap)


class ViewSamplerArbitrary:
    def __init__(self, num_context_views: int = 2, num_target_views: int = 4):
        self.num_context_views = num_context_views
        self.num_target_views = num_target_views

    def sample(self, scene, num_views, rng, global_step: int = 0) -> SampledViews:
        context = rng.choice(num_views, self.num_context_views, replace=False)
        target = rng.choice(num_views, self.num_target_views, replace=True)
        return SampledViews(np.sort(context).astype(np.int64), target.astype(np.int64))


class ViewSamplerAll:
    def sample(self, scene, num_views, rng=None, global_step: int = 0) -> SampledViews:
        idx = np.arange(num_views, dtype=np.int64)
        return SampledViews(idx, idx)


def make_view_sampler(name: str, **kwargs):
    return {
        "bounded": ViewSamplerBounded,
        "evaluation": ViewSamplerEvaluation,
        "arbitrary": ViewSamplerArbitrary,
        "all": ViewSamplerAll,
    }[name](**kwargs)
