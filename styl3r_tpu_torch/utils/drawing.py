"""Vector drawing onto images (counterpart of styl3r_tpu/utils/drawing.py;
reference `src/visualization/drawing/{lines,points,cameras,
coordinate_conversion,rendering,types}.py`).

Every primitive's coverage is an analytic signed distance with a 1-pixel
smooth edge, computed for all pixels at once; primitives composite in
order, so the last one drawn is on top (the reference's argmax-by-index
rule, lines.py:72-79). Images are channel-last (h, w, 3) f32 tensors in
[0, 1].
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor


def _sanitize_vector(x, dim: int, n: Optional[int] = None) -> Tensor:
    """-> (n, dim) f32 (types.py sanitize_vector)."""
    x = torch.atleast_2d(torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x).float())
    if x.shape[-1] != dim:
        raise ValueError(f"expected last dim {dim}, got {tuple(x.shape)}")
    x = x.reshape(-1, dim)
    if n is not None:
        x = x.expand(n, dim)
    return x


def _sanitize_scalar(x, n: Optional[int] = None) -> Tensor:
    x = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x).float().reshape(-1)
    if n is not None:
        x = x.expand(n)
    return x


def generate_conversions(
    shape: Tuple[int, int],
    x_range: Optional[Sequence[float]] = None,
    y_range: Optional[Sequence[float]] = None,
):
    """(world->pixel, pixel->world) affine maps (coordinate_conversion.py:19-44).
    Without ranges, world space is pixel space."""
    h, w = shape
    x_range = (0.0, float(w)) if x_range is None else x_range
    y_range = (0.0, float(h)) if y_range is None else y_range
    minima = torch.tensor([x_range[0], y_range[0]], dtype=torch.float32)
    maxima = torch.tensor([x_range[1], y_range[1]], dtype=torch.float32)
    wh = torch.tensor([w, h], dtype=torch.float32)

    def world_to_pixel(xy: Tensor) -> Tensor:
        return (xy - minima.to(xy.device)) / (maxima - minima).to(xy.device) * wh.to(xy.device)

    def pixel_to_world(xy: Tensor) -> Tensor:
        return xy / wh.to(xy.device) * (maxima - minima).to(xy.device) + minima.to(xy.device)

    return world_to_pixel, pixel_to_world


def _pixel_grid(h: int, w: int, device=None) -> Tensor:
    """(h, w, 2) xy of the pixel centers (rendering.py:18-26)."""
    x = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    y = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    yg, xg = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xg, yg], dim=-1)


def _coverage(sdf: Tensor) -> Tensor:
    """Anti-aliased coverage from a signed distance in pixels."""
    return torch.clamp(0.5 - sdf, 0.0, 1.0)


def _paint(image: Tensor, coverages: Tensor, colors: Tensor) -> Tensor:
    """Composite (n, h, w) coverages with (n, 3) colors over (h, w, 3), in
    order: later primitives cover earlier ones."""
    for cov, col in zip(coverages, colors):
        image = image + cov[..., None] * (col - image)
    return image


def draw_lines(
    image: Tensor,
    start,
    end,
    color=(1.0, 1.0, 1.0),
    width=1.0,
    cap: str = "round",
    x_range: Optional[Sequence[float]] = None,
    y_range: Optional[Sequence[float]] = None,
) -> Tensor:
    """Anti-aliased segments over `image` (lines.py:13-83). start/end: (n, 2)
    world xy (pixel space without ranges); width in pixels; cap in {'butt',
    'round', 'square'}."""
    h, w, _ = image.shape
    dev = image.device
    start = _sanitize_vector(start, 2).to(dev)
    end = _sanitize_vector(end, 2).to(dev)
    n = int(np.broadcast_shapes(
        start.shape[:1], end.shape[:1], tuple(_sanitize_scalar(width).shape),
        tuple(_sanitize_vector(color, 3).shape[:1]),
    )[0])
    start = start.expand(n, 2)
    end = end.expand(n, 2)
    color = _sanitize_vector(color, 3, n).to(dev)
    width = _sanitize_scalar(width, n).to(dev)

    world_to_pixel, _ = generate_conversions((h, w), x_range, y_range)
    s = world_to_pixel(start)[:, None, None]  # (n, 1, 1, 2)
    e = world_to_pixel(end)[:, None, None]
    wd = width[:, None, None]
    xy = _pixel_grid(h, w, dev)  # (h, w, 2)

    delta = e - s
    norm = torch.clamp(torch.linalg.norm(delta, dim=-1), min=1e-8)  # (n, 1, 1)
    u = delta / norm[..., None]
    rel = xy - s  # (n, h, w, 2)
    t = (rel * u).sum(-1)  # along the segment
    if cap == "square":
        t_clamped = torch.minimum(torch.maximum(t, -0.5 * wd), norm + 0.5 * wd)
    else:  # butt, round: the capsule's distance
        t_clamped = torch.minimum(torch.clamp(t, min=0.0), norm)
    if cap in ("butt", "square"):
        # Hard ends: outside the segment's span the pixel stays empty
        # (the reference's parallel_inside_line, lines.py:55-57).
        perp = torch.linalg.norm(rel - t[..., None] * u, dim=-1)
        lo = torch.zeros_like(wd) if cap == "butt" else -0.5 * wd
        hi = norm if cap == "butt" else norm + 0.5 * wd
        coverages = _coverage(perp - 0.5 * wd) * _coverage(torch.maximum(lo - t, t - hi))
    else:
        closest = s + t_clamped[..., None] * u
        coverages = _coverage(torch.linalg.norm(xy - closest, dim=-1) - 0.5 * wd)
    return _paint(image, coverages, color)


def draw_points(
    image: Tensor,
    points,
    color=(1.0, 1.0, 1.0),
    radius=1.0,
    inner_radius=0.0,
    x_range: Optional[Sequence[float]] = None,
    y_range: Optional[Sequence[float]] = None,
) -> Tensor:
    """Anti-aliased discs or annuli over `image` (points.py:13-59)."""
    h, w, _ = image.shape
    dev = image.device
    points = _sanitize_vector(points, 2).to(dev)
    n = points.shape[0]
    color = _sanitize_vector(color, 3, n).to(dev)
    radius = _sanitize_scalar(radius, n).to(dev)[:, None, None]
    inner_radius = _sanitize_scalar(inner_radius, n).to(dev)[:, None, None]

    world_to_pixel, _ = generate_conversions((h, w), x_range, y_range)
    p = world_to_pixel(points)[:, None, None]
    d = torch.linalg.norm(_pixel_grid(h, w, dev) - p, dim=-1)
    # Inside iff inner_radius <= d <= radius.
    coverages = _coverage(torch.maximum(d - radius, inner_radius - d))
    return _paint(image, coverages, color)


# ---------------------------------------------------------------------------
# Camera wireframe projections (drawing/cameras.py)
# ---------------------------------------------------------------------------


def unproject_frustum_corners(extrinsics: Tensor, intrinsics: Tensor, depth) -> Tensor:
    """(b, 4, 3) world-space frustum corners at z-depth `depth`
    (cameras.py:169-195), in order around the image rectangle."""
    xy = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]], device=extrinsics.device)
    k_inv = torch.linalg.inv(intrinsics)
    dirs = torch.einsum("bij,pj->bpi", k_inv, torch.cat([xy, torch.ones(4, 1, device=xy.device)], dim=-1))
    dirs = dirs / dirs[..., -1:]  # z-depth, not euclidean
    dirs = torch.einsum("bij,bpj->bpi", extrinsics[:, :3, :3], dirs)
    origins = extrinsics[:, None, :3, 3]
    depth = torch.as_tensor(depth, dtype=torch.float32, device=extrinsics.device).reshape(-1, 1, 1)
    return origins + depth * dirs


def compute_aabb(extrinsics: Tensor, intrinsics: Tensor, near=None, far=None) -> Tuple[Tensor, Tensor]:
    """Bounds of the camera positions and frustum corners (cameras.py:123-150)."""
    points = [extrinsics[:, :3, 3]]
    for plane in (near, far):
        if plane is not None:
            points.append(unproject_frustum_corners(extrinsics, intrinsics, plane).reshape(-1, 3))
    points = torch.cat(points, dim=0)
    return points.min(dim=0).values, points.max(dim=0).values


def compute_equal_aabb_with_margin(minima: Tensor, maxima: Tensor, margin: float = 0.1) -> Tuple[Tensor, Tensor]:
    """A cube around the bounds with a relative margin (cameras.py:153-166)."""
    midpoint = (maxima + minima) * 0.5
    span = (maxima - minima).max() * (1 + margin)
    return midpoint - 0.5 * span, midpoint + 0.5 * span


def draw_cameras(
    resolution: int,
    extrinsics,
    intrinsics,
    color,
    near=None,
    far=None,
    margin: float = 0.1,
    frustum_scale: float = 0.05,
    label: bool = True,
) -> np.ndarray:
    """Three axis-aligned orthographic projections of the camera frustums
    (cameras.py:14-121): (3, res, res, 3) float images, labeled with their
    plane."""
    from .viz import annotate

    extrinsics = torch.as_tensor(np.asarray(extrinsics, np.float32))
    intrinsics = torch.as_tensor(np.asarray(intrinsics, np.float32))
    b = extrinsics.shape[0]
    color = _sanitize_vector(color, 3, b)

    def planes(depth):
        return unproject_frustum_corners(extrinsics, intrinsics, torch.full((b,), float(depth)))

    minima, maxima = compute_aabb(extrinsics, intrinsics, near, far)
    scene_min, scene_max = compute_equal_aabb_with_margin(minima, maxima, margin)
    span = (scene_max - scene_min).max()
    frustum = unproject_frustum_corners(extrinsics, intrinsics, (span * frustum_scale).expand(b))
    near_c = planes(near) if near is not None else None
    far_c = planes(far) if far is not None else None

    projections = []
    for axis in range(3):
        ax_x, ax_y = (axis + 1) % 3, (axis + 2) % 3

        def proj(p):
            return torch.stack([p[..., ax_x], p[..., ax_y]], dim=-1)

        ranges = dict(
            x_range=(float(scene_min[ax_x]), float(scene_max[ax_x])),
            y_range=(float(scene_min[ax_y]), float(scene_max[ax_y])),
        )
        image = torch.zeros(resolution, resolution, 3)
        grey = (0.25, 0.25, 0.25)
        for plane_c in (near_c, far_c):
            if plane_c is not None:
                image = draw_lines(image, proj(torch.roll(plane_c, 1, dims=1)).reshape(-1, 2),
                                   proj(plane_c).reshape(-1, 2), color=grey, width=2, **ranges)
        if near_c is not None and far_c is not None:
            image = draw_lines(image, proj(near_c).reshape(-1, 2), proj(far_c).reshape(-1, 2),
                               color=grey, width=2, **ranges)

        # Frustum edges: origin -> each corner, then the ring of corners.
        origins2 = proj(extrinsics[:, :3, 3]).repeat_interleave(4, dim=0)
        corners2 = proj(frustum).reshape(-1, 2)
        prev2 = proj(torch.roll(frustum, 1, dims=1)).reshape(-1, 2)
        col4 = color.repeat_interleave(4, dim=0)
        image = draw_lines(image, torch.cat([origins2, prev2]), torch.cat([corners2, corners2]),
                           color=torch.cat([col4, col4]), width=2, **ranges)

        img_np = image.numpy()
        if label:
            img_np = annotate(img_np, f"{'XYZ'[ax_x]}{'XYZ'[ax_y]} Projection")
        projections.append(img_np)
    return np.stack(projections)
