"""Visualization utilities (counterpart of styl3r_tpu/utils/viz.py;
reference `src/visualization/`): image layout (hcat/vcat/add_border), the
turbo depth color map, line/point drawing in numpy, camera frustum
wireframes and text labels, for validation's comparison grids and camera
plots. numpy and PIL only.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .turbo import TURBO

_TURBO = np.asarray(TURBO)


# --------------------------------------------------------------------------
# Layout (src/visualization/layout.py)
# --------------------------------------------------------------------------


def _to_image(x) -> np.ndarray:
    arr = np.asarray(x, np.float32)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    return arr


def add_border(image, width: int = 4, color=(1.0, 1.0, 1.0)) -> np.ndarray:
    image = _to_image(image)
    h, w, c = image.shape
    out = np.empty((h + 2 * width, w + 2 * width, c), image.dtype)
    out[...] = np.asarray(color, image.dtype)
    out[width : width + h, width : width + w] = image
    return out


def _pad_to(image: np.ndarray, h: int, w: int, color=(0, 0, 0)) -> np.ndarray:
    out = np.empty((h, w, image.shape[2]), image.dtype)
    out[...] = np.asarray(color, image.dtype)
    out[: image.shape[0], : image.shape[1]] = image
    return out


def hcat(*images, gap: int = 2, color=(1.0, 1.0, 1.0)) -> np.ndarray:
    images = [_to_image(im) for im in images]
    h = max(im.shape[0] for im in images)
    cols = []
    for i, im in enumerate(images):
        cols.append(_pad_to(im, h, im.shape[1], color))
        if i != len(images) - 1 and gap:
            cols.append(np.full((h, gap, 3), color, np.float32))
    return np.concatenate(cols, axis=1)


def vcat(*images, gap: int = 2, color=(1.0, 1.0, 1.0)) -> np.ndarray:
    images = [_to_image(im) for im in images]
    w = max(im.shape[1] for im in images)
    rows = []
    for i, im in enumerate(images):
        rows.append(_pad_to(im, im.shape[0], w, color))
        if i != len(images) - 1 and gap:
            rows.append(np.full((gap, w, 3), color, np.float32))
    return np.concatenate(rows, axis=0)


# --------------------------------------------------------------------------
# Color map (src/visualization/color_map.py)
# --------------------------------------------------------------------------


def apply_color_map(values: np.ndarray) -> np.ndarray:
    """(...,) values in [0, 1] -> (..., 3) turbo RGB, looked up as
    matplotlib's ListedColormap does: index floor(v * 256), 1.0 -> 255."""
    xa = np.clip(np.asarray(values), 0, 1) * len(TURBO)
    xa[xa == len(TURBO)] = len(TURBO) - 1
    return _TURBO[xa.astype(int)].astype(np.float32)


def color_map_depth(depth: np.ndarray, invert: bool = True) -> np.ndarray:
    """Normalize depth to [0,1] (near = hot) and colorize."""
    d = np.asarray(depth, np.float32)
    lo, hi = np.quantile(d, 0.01), np.quantile(d, 0.99)
    norm = np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1)
    if invert:
        norm = 1 - norm
    return apply_color_map(norm)


# --------------------------------------------------------------------------
# Drawing (src/visualization/drawing/{lines,points}.py — numpy variant)
# --------------------------------------------------------------------------


def draw_points(
    image: np.ndarray, points_xy: np.ndarray, color=(1.0, 0.0, 0.0), radius: int = 1
) -> np.ndarray:
    """points_xy in pixel coords (x, y)."""
    out = _to_image(image).copy()
    h, w = out.shape[:2]
    color = np.asarray(color, np.float32)
    for x, y in np.asarray(points_xy).reshape(-1, 2):
        xi, yi = int(round(x)), int(round(y))
        y0, y1 = max(yi - radius, 0), min(yi + radius + 1, h)
        x0, x1 = max(xi - radius, 0), min(xi + radius + 1, w)
        if y0 < y1 and x0 < x1:
            out[y0:y1, x0:x1] = color
    return out


def draw_lines(
    image: np.ndarray, starts: np.ndarray, ends: np.ndarray, color=(0.0, 1.0, 0.0)
) -> np.ndarray:
    out = _to_image(image).copy()
    h, w = out.shape[:2]
    color = np.asarray(color, np.float32)
    starts = np.asarray(starts).reshape(-1, 2)
    ends = np.asarray(ends).reshape(-1, 2)
    for (x0, y0), (x1, y1) in zip(starts, ends):
        n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
        xs = np.linspace(x0, x1, n).round().astype(int)
        ys = np.linspace(y0, y1, n).round().astype(int)
        valid = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        out[ys[valid], xs[valid]] = color
    return out


# --------------------------------------------------------------------------
# Camera wireframes (src/visualization/drawing/cameras.py)
# --------------------------------------------------------------------------


def camera_frustum_points(
    extrinsics: np.ndarray, intrinsics: np.ndarray, scale: float = 0.2
) -> np.ndarray:
    """World-space frustum wireframe segments (n_seg, 2, 3) for one camera."""
    k_inv = np.linalg.inv(intrinsics)
    corners_px = np.asarray(
        [[0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float64
    )
    rays = (k_inv @ corners_px.T).T
    rays = rays / rays[:, 2:3] * scale
    cam_pts = np.concatenate([np.zeros((1, 3)), rays], axis=0)  # apex + 4 corners
    world = (extrinsics[:3, :3] @ cam_pts.T).T + extrinsics[:3, 3]
    apex, c = world[0], world[1:]
    segs = []
    for i in range(4):
        segs.append([apex, c[i]])
        segs.append([c[i], c[(i + 1) % 4]])
    return np.asarray(segs)


def draw_cameras_topdown(
    extrinsics: np.ndarray,  # (n, 4, 4)
    intrinsics: np.ndarray,  # (n, 3, 3)
    image_size: int = 256,
    axes: Tuple[int, int] = (0, 2),  # project onto x/z plane
    colors: Optional[Sequence] = None,
) -> np.ndarray:
    """Orthographic top-down plot of camera frusta (replaces the reference's
    render_cuda_orthographic-based camera viz)."""
    all_segs = [
        camera_frustum_points(e, k) for e, k in zip(extrinsics, intrinsics)
    ]
    pts = np.concatenate([s.reshape(-1, 3) for s in all_segs])[:, list(axes)]
    lo = pts.min(axis=0) - 0.1
    hi = pts.max(axis=0) + 0.1
    span = max((hi - lo).max(), 1e-6)

    def to_px(p):
        return (p - lo) / span * (image_size - 1)

    img = np.ones((image_size, image_size, 3), np.float32)
    palette = colors or [(0.9, 0.2, 0.2), (0.2, 0.5, 0.9), (0.2, 0.8, 0.3), (0.8, 0.7, 0.1)]
    for i, segs in enumerate(all_segs):
        color = palette[i % len(palette)]
        s2 = to_px(segs[:, 0][:, list(axes)])
        e2 = to_px(segs[:, 1][:, list(axes)])
        img = draw_lines(img, s2, e2, color)
    return img


def annotate(image: np.ndarray, text: str, color=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Add a text label above an image (src/visualization/annotation.py)."""
    from PIL import Image, ImageDraw

    image = _to_image(image)
    w = image.shape[1]
    bar = Image.new("RGB", (w, 16), (0, 0, 0))
    draw = ImageDraw.Draw(bar)
    draw.text((2, 2), text, fill=tuple(int(c * 255) for c in color))
    bar_arr = np.asarray(bar, np.float32) / 255.0
    return np.concatenate([bar_arr, image], axis=0)


def validation_gallery(
    context_images: np.ndarray,  # (v, h, w, 3)
    target_gt: np.ndarray,  # (t, h, w, 3)
    prediction: np.ndarray,  # (t, h, w, 3)
    depth: np.ndarray = None,  # (t, h, w) optional
    style_image: np.ndarray = None,  # (hs, ws, 3) optional
) -> np.ndarray:
    """The reference's validation comparison gallery
    (model_wrapper_style.py:471-543: labeled rows of context / GT / predicted
    [/ depth] stacked into one grid image)."""
    rows = [
        annotate(hcat(*[_to_image(im) for im in context_images]), "context"),
        annotate(hcat(*[_to_image(im) for im in target_gt]), "target (gt)"),
        annotate(hcat(*[_to_image(im) for im in prediction]), "prediction"),
    ]
    if depth is not None:
        rows.append(
            annotate(hcat(*[color_map_depth(np.asarray(d)) for d in depth]), "depth")
        )
    if style_image is not None:
        rows.append(annotate(_to_image(style_image), "style"))
    return vcat(*rows)


def ortho_projection_cameras(
    means: np.ndarray, margin: float = 0.1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Three axis-aligned orthographic cameras (front/top/side) covering a
    gaussian cloud, for the reference's validation projections
    (src/visualization/validation_in_3d.py render_projections). Returns
    (extrinsics (3,4,4) c2w, width (3,), height (3,), near (3,), far (3,));
    feed to models/decoder.py::render_orthographic.

    Outlier-robust bounds: 2/98 percentiles of the means per axis.
    """
    pts = np.asarray(means, np.float64).reshape(-1, 3)
    lo = np.percentile(pts, 2.0, axis=0)
    hi = np.percentile(pts, 98.0, axis=0)
    center = 0.5 * (lo + hi)
    span = np.maximum(hi - lo, 1e-3)

    # (rotation columns = camera x/y/z axes in world, in-plane axes, depth axis)
    views = [
        (np.eye(3), (0, 1), 2),  # front: looking along +z, x/y in plane
        (np.asarray([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float64), (0, 2), 1),  # top
        (np.asarray([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float64), (2, 1), 0),  # side
    ]
    exts, widths, heights, nears, fars = [], [], [], [], []
    for rot, (ax_x, ax_y), ax_d in views:
        ext = np.eye(4)
        ext[:3, :3] = rot
        ext[:3, 3] = center
        exts.append(ext)
        widths.append(span[ax_x] * (1 + 2 * margin))
        heights.append(span[ax_y] * (1 + 2 * margin))
        half = 0.5 * span[ax_d] * (1 + 2 * margin)
        nears.append(-half)
        fars.append(half)
    return (
        np.asarray(exts, np.float32),
        np.asarray(widths, np.float32),
        np.asarray(heights, np.float32),
        np.asarray(nears, np.float32),
        np.asarray(fars, np.float32),
    )
