"""Inference: the pipeline with pose alignment, camera trajectories and the
entry points (counterpart of styl3r_tpu/infer/ and the repo's infer_*.py)."""

from .pipeline import InferencePipeline, align_target_poses
from .trajectory import interpolate_extrinsics, interpolate_intrinsics, wobble_extrinsics

__all__ = [
    "InferencePipeline",
    "align_target_poses",
    "interpolate_extrinsics",
    "interpolate_intrinsics",
    "wobble_extrinsics",
]
