"""Camera projection and ray geometry (counterpart of
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


def homogenize_vectors(vectors: Tensor) -> Tensor:
    """(..., d) xyz -> (..., d + 1) xyz0."""
    return torch.cat([vectors, torch.zeros_like(vectors[..., :1])], dim=-1)


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


def unproject(coordinates: Tensor, z: Tensor, intrinsics: Tensor) -> Tensor:
    """Normalized 2-D coordinates at depth z -> camera-space points."""
    rays = torch.einsum("...ij,...j->...i", torch.linalg.inv(intrinsics), homogenize_points(coordinates))
    return rays * z[..., None]


def get_world_rays(coordinates: Tensor, extrinsics: Tensor, intrinsics: Tensor) -> Tuple[Tensor, Tensor]:
    """World-space ray origins and unit directions through normalized
    coordinates (reference projection.py:91-114)."""
    directions = unproject(coordinates, torch.ones_like(coordinates[..., 0]), intrinsics)
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    directions = transform_rigid(homogenize_vectors(directions), extrinsics)[..., :3]
    origins = extrinsics[..., :3, 3].expand(directions.shape)
    return origins, directions


def sample_image_grid(shape: Tuple[int, int]) -> Tuple[Tensor, Tensor]:
    """(h, w, 2) normalized half-pixel-center (x, y) coordinates and (h, w,
    2) integer (row, col) indices of an image grid (reference
    projection.py:131-152)."""
    h, w = shape
    rows = torch.arange(h)
    cols = torch.arange(w)
    indices = torch.stack(torch.meshgrid(rows, cols, indexing="ij"), dim=-1)
    x = (cols + 0.5) / w
    y = (rows + 0.5) / h
    coords = torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)
    return coords, indices


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


def intersect_rays(
    origins_x: Tensor,
    directions_x: Tensor,
    origins_y: Tensor,
    directions_y: Tensor,
    eps: float = 1e-5,
    inf: float = 1e10,
) -> Tensor:
    """Least-squares intersection points of two ray bundles; pairs of
    (near-)parallel rays give `inf` (reference projection.py:189-240, with
    those pairs masked rather than indexed out, as the JAX package does)."""
    shape = torch.broadcast_shapes(origins_x.shape, directions_x.shape, origins_y.shape, directions_y.shape)
    ox, dx, oy, dy = (x.expand(shape) for x in (origins_x, directions_x, origins_y, directions_y))
    parallel = (dx * dy).sum(-1) > 1 - eps

    origins = torch.stack([ox, oy], dim=0)
    directions = torch.stack([dx, dy], dim=0)
    eye = torch.eye(3, dtype=dx.dtype, device=dx.device)
    n = torch.einsum("r...i,r...j->r...ij", directions, directions) - eye
    lhs = n.sum(0) + 1e-10 * eye
    rhs = torch.einsum("r...ij,r...j->r...i", n, origins).sum(0)
    result = torch.linalg.solve(lhs, rhs[..., None])[..., 0]
    return torch.where(parallel[..., None], torch.full_like(result, inf), result)


def get_local_rays_basis(coordinates: Tensor, intrinsics: Tensor) -> Tensor:
    """Unit camera-space ray directions through normalized coordinates
    (reference get_local_rays, projection.py:117-128)."""
    directions = unproject(coordinates, torch.ones_like(coordinates[..., 0]), intrinsics)
    return directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
