"""Camera geometry (the part of styl3r_tpu/geometry/projection.py that the
renderer needs): normalized intrinsics, c2w extrinsics."""

from __future__ import annotations

import torch
from torch import Tensor


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
