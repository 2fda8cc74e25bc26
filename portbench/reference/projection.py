"""[Frozen copy of styl3r_tpu_torch/geometry/projection.py, the benchmark's reference: it
imports nothing of the program.]

Camera projection and ray geometry (counterpart of
styl3r_tpu/geometry/projection.py; reference `src/geometry/projection.py`):
normalized (0..1) image coordinates, OpenCV-convention camera-to-world
(4, 4) extrinsics and normalized (3, 3) intrinsics."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor


def homogenize_points(points: Tensor) -> Tensor:
    """(..., d) xyz -> (..., d + 1) xyz1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def transform_rigid(homogeneous: Tensor, transformation: Tensor) -> Tensor:
    """Apply (..., 4, 4) rigid transforms to homogeneous points or vectors."""
    return torch.einsum("...ij,...j->...i", transformation, homogeneous)


def invert_se3(extrinsics: Tensor) -> Tensor:
    """Invert (..., 4, 4) rigid transforms analytically."""
    rot_t = extrinsics[..., :3, :3].transpose(-1, -2)
    t = extrinsics[..., :3, 3]
    t_new = -torch.einsum("...ij,...j->...i", rot_t, t)
    top = torch.cat([rot_t, t_new[..., None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=extrinsics.dtype, device=extrinsics.device
    ).expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def project(
    points: Tensor, extrinsics: Tensor, intrinsics: Tensor, epsilon: float = 1.1920929e-07
) -> Tuple[Tensor, Tensor]:
    """Project world points through c2w cameras: (xy in normalized image
    coordinates, in-front mask) (reference projection.py:59-71)."""
    cam = transform_rigid(homogenize_points(points), invert_se3(extrinsics))[..., :3]
    in_front = cam[..., -1] >= 0
    cam = cam / (cam[..., -1:] + epsilon)
    cam = torch.nan_to_num(cam, posinf=1e8, neginf=-1e8)
    pixel = torch.einsum("...ij,...j->...i", intrinsics, cam)
    return pixel[..., :2], in_front


def get_fov(intrinsics: Tensor) -> Tensor:
    """(..., 2) horizontal/vertical field of view (radians) of normalized
    intrinsics: the angle between the rays through opposite edge midpoints."""
    k_inv = torch.linalg.inv(intrinsics)

    def ray(vec):
        v = torch.einsum(
            "...ij,j->...i",
            k_inv,
            torch.tensor(vec, dtype=intrinsics.dtype, device=intrinsics.device),
        )
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    left, right = ray([0.0, 0.5, 1.0]), ray([1.0, 0.5, 1.0])
    top, bottom = ray([0.5, 0.0, 1.0]), ray([0.5, 1.0, 1.0])
    fov_x = torch.arccos(torch.clamp((left * right).sum(-1), -1.0, 1.0))
    fov_y = torch.arccos(torch.clamp((top * bottom).sum(-1), -1.0, 1.0))
    return torch.stack([fov_x, fov_y], dim=-1)
