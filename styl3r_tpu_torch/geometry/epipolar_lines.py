"""Epipolar line segments: world rays projected into other cameras' image
planes (counterpart of styl3r_tpu/geometry/epipolar_lines.py; reference
`src/geometry/epipolar_lines.py`, NoPoSplat's epipolar toolkit).

Each ray's on-screen segment is clipped to the image frame and to the
optional near/far planes; `lift_to_3d` and `get_depth` take 2-D points on
those segments back to 3-D and to depths. Every function broadcasts over
any leading batch shape. As in the JAX package, the reference's masked
in-place updates are selects over fixed shapes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import Tensor

from .projection import (
    get_world_rays,
    homogenize_points,
    homogenize_vectors,
    intersect_rays,
    invert_se3,
    transform_rigid,
)


def _is_in_bounds(xy: Tensor, epsilon: float = 1e-6) -> Tensor:
    """Inside the normalized [0, 1]^2 image plane (epipolar_lines.py:19-26)."""
    return (xy >= -epsilon).all(dim=-1) & (xy <= 1 + epsilon).all(dim=-1)


def _is_in_front_of_camera(xyz: Tensor, epsilon: float = 1e-6) -> Tensor:
    return xyz[..., -1] > -epsilon


def _is_positive_t(t: Tensor, epsilon: float = 1e-6) -> Tensor:
    return t > -epsilon


class PointProjection(NamedTuple):
    t: Tensor  # ray parameter: xyz = origin + t * direction
    xy: Tensor  # image-space xy, normalized to [0, 1]
    valid: Tensor  # in front of the camera, inside the frame and t > 0


def project_camera_space(
    points: Tensor, intrinsics: Tensor, epsilon: float = 1.1920929e-07, infinity: float = 1e8
) -> Tensor:
    """Perspective divide, then K (reference projection.py:47-56)."""
    points = points / (points[..., -1:] + epsilon)
    points = torch.nan_to_num(points, posinf=infinity, neginf=-infinity)
    points = torch.einsum("...ij,...j->...i", intrinsics, points)
    return points[..., :-1]


def _intersect_image_coordinate(
    intrinsics: Tensor, origins: Tensor, directions: Tensor, dim: int, coordinate_value: float
) -> PointProjection:
    """Where a camera-space ray's projection crosses the frame line
    {x, y}[dim] = coordinate_value (epipolar_lines.py:56-103). Infinite t
    and coordinates are left to the validity mask."""
    other_dim = 1 - dim
    fs = intrinsics[..., dim, dim]
    fo = intrinsics[..., other_dim, other_dim]
    cs = intrinsics[..., dim, 2]
    co = intrinsics[..., other_dim, 2]
    os_, oo, oz = origins[..., dim], origins[..., other_dim], origins[..., 2]
    ds, do, dz = directions[..., dim], directions[..., other_dim], directions[..., 2]
    c = (coordinate_value - cs) / fs

    t = (c * oz - os_) / (ds - c * dz)
    coordinate_other = co + (fo * (oo * (c * dz - ds) + do * (os_ - c * oz))) / (dz * os_ - ds * oz)
    parts = [torch.full_like(coordinate_other, coordinate_value)]
    parts.insert(other_dim, coordinate_other)
    xy = torch.stack(parts, dim=-1)
    xyz = origins + t[..., None] * directions
    return PointProjection(t=t, xy=xy, valid=_is_in_bounds(xy) & _is_in_front_of_camera(xyz) & _is_positive_t(t))


def _compare_projections(intersections: Sequence[PointProjection], reduction: str) -> PointProjection:
    """The min- or max-t valid intersection of each ray
    (epipolar_lines.py:106-130). Invalid candidates are filled with +-inf,
    which nan_to_num turns into the dtype's largest finite value, as
    jnp.nan_to_num does; a NaN t loses to every other candidate; ties go to
    the first candidate."""
    t = torch.stack([i.t for i in intersections])
    xy = torch.stack([i.xy for i in intersections])
    valid = torch.stack([i.valid for i in intersections])

    lowest_priority = {"min": float("inf"), "max": float("-inf")}[reduction]
    t = torch.nan_to_num(torch.where(valid, t, lowest_priority), nan=lowest_priority)
    selector = (t.argmin(dim=0) if reduction == "min" else t.argmax(dim=0))[None]
    return PointProjection(
        t=t.gather(0, selector)[0],
        xy=xy.gather(0, selector[..., None].expand(1, *xy.shape[1:]))[0],
        valid=valid.gather(0, selector)[0],
    )


def _compute_point_projection(xyz: Tensor, t: Tensor, intrinsics: Tensor) -> PointProjection:
    xy = project_camera_space(xyz, intrinsics)
    return PointProjection(t=t, xy=xy, valid=_is_in_bounds(xy) & _is_in_front_of_camera(xyz) & _is_positive_t(t))


class RaySegmentProjection(NamedTuple):
    t_min: Tensor  # ray parameter at the segment's start
    t_max: Tensor  # ray parameter at its end
    xy_min: Tensor  # normalized image xy at the start
    xy_max: Tensor  # normalized image xy at the end
    # Whether the segment overlaps the image; where it does not, the values
    # above mean nothing (the reference's contract).
    overlaps_image: Tensor


def project_rays(
    origins: Tensor,
    directions: Tensor,
    extrinsics: Tensor,
    intrinsics: Tensor,
    near: Optional[Tensor] = None,
    far: Optional[Tensor] = None,
    epsilon: float = 1e-6,
) -> RaySegmentProjection:
    """The on-screen segment of each world ray's projection into a
    c2w camera (epipolar_lines.py:158-250)."""
    world_to_cam = invert_se3(extrinsics)
    origins_c = transform_rigid(homogenize_points(origins), world_to_cam)[..., :3]
    directions_c = transform_rigid(homogenize_vectors(directions), world_to_cam)[..., :3]

    frame_intersections = [
        _intersect_image_coordinate(intrinsics, origins_c, directions_c, dim, val)
        for dim in (0, 1)
        for val in (0.0, 1.0)
    ]
    fmin = _compare_projections(frame_intersections, "min")
    fmax = _compare_projections(frame_intersections, "max")

    if near is None:
        # The projection at zero depth; a ray starting at the camera uses
        # its direction, and an origin merely on the zero-depth plane is
        # invalid (epipolar_lines.py:188-208).
        mask_depth_zero = origins_c[..., -1] < epsilon
        mask_at_camera = torch.linalg.norm(origins_c, dim=-1) < epsilon
        origins_for_projection = torch.where(mask_at_camera[..., None], directions_c, origins_c)
        pz = _compute_point_projection(origins_for_projection, torch.zeros_like(fmin.t), intrinsics)
        pz = pz._replace(valid=pz.valid & ~(mask_depth_zero & ~mask_at_camera))
    else:
        near = torch.broadcast_to(near, fmin.t.shape)
        pz = _compute_point_projection(origins_c + near[..., None] * directions_c, near, intrinsics)

    if far is None:
        # The direction's projection is the point at infinite depth.
        pinf = _compute_point_projection(directions_c, torch.full_like(fmax.t, float("inf")), intrinsics)
    else:
        far = torch.broadcast_to(far, fmax.t.shape)
        pinf = _compute_point_projection(origins_c + far[..., None] * directions_c, far, intrinsics)

    # The reference's four valid/invalid cases are two independent selects:
    # a valid endpoint projection wins over the frame intersection.
    def pick(valid: Tensor, a: PointProjection, b: PointProjection) -> PointProjection:
        return PointProjection(
            t=torch.where(valid, a.t, b.t),
            xy=torch.where(valid[..., None], a.xy, b.xy),
            valid=torch.where(valid, a.valid, b.valid),
        )

    lo = pick(pz.valid, pz, fmin)
    hi = pick(pinf.valid, pinf, fmax)
    return RaySegmentProjection(t_min=lo.t, t_max=hi.t, xy_min=lo.xy, xy_max=hi.xy,
                                overlaps_image=lo.valid & hi.valid)


def lift_to_3d(origins: Tensor, directions: Tensor, xy: Tensor, extrinsics: Tensor, intrinsics: Tensor) -> Tensor:
    """3-D positions of 2-D points on the epipolar lines of the rays
    (origins, directions) (epipolar_lines.py:262-275); the camera is the
    one the 2-D points lie in."""
    xy_origins, xy_directions = get_world_rays(xy, extrinsics, intrinsics)
    return intersect_rays(origins, directions, xy_origins, xy_directions)


def get_depth(origins: Tensor, directions: Tensor, xy: Tensor, extrinsics: Tensor, intrinsics: Tensor) -> Tensor:
    """Distances from the ray origins of 2-D points on their epipolar lines
    (epipolar_lines.py:278-292)."""
    xyz = lift_to_3d(origins, directions, xy, extrinsics, intrinsics)
    return torch.linalg.norm(xyz - origins, dim=-1)
