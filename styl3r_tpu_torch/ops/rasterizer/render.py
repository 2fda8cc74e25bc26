"""Differentiable tile-based Gaussian splatting renderer (counterpart of
styl3r_tpu/ops/rasterizer/render.py with impl="pallas").

  1. project Gaussians (EWA, project.py);
  2. bin: each Gaussian emits up to `max_tiles_per_gaussian` (tile, depth)
     pairs over its 3-sigma bbox, culled exactly by the ellipse-tile test;
     one stable sort of all views' pairs by a packed (tile, depth) key;
     per-tile ranges from searchsorted;
  3. composite: per 16x16 tile, front to back (composite.py: the CUDA
     kernel, or its plain version), with the backward kernel as its
     gradient.

All n views share one sort and one compositor launch: view i's tiles are
offset by i * tiles_per_view. Gradients reach the Gaussians and the camera
deltas by autograd: the `pack_attrs` gather's backward is index_select's
(an index_add_ into the per-Gaussian table; slots dropped by pair_cap get
none), then projection, eval_sh and make_raster_camera.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ...utils import trace
from .camera import RasterCamera
from .composite import composite_tiles_diff, pack_attrs
from .project import eval_sh, project_gaussians

TILE = 16
MIN_DEPTH_KEY_BITS = 14  # >= 6 exponent-range + 8 mantissa bits of depth


class RenderOutput(NamedTuple):
    color: Tensor  # (..., h, w, 3)
    depth: Tensor  # (..., h, w) alpha-weighted expected depth
    alpha: Tensor  # (..., h, w) accumulated opacity
    # Live (tile, depth) pairs of the fused sort and the slots kept for
    # compositing; the pair_cap truncation was lossless iff live <= slots.
    live_pairs: Optional[Tensor] = None  # i32 scalar
    pair_slots: Optional[Tensor] = None  # i32 scalar


def _build_pairs(
    mean_x: Tensor,
    mean_y: Tensor,
    radii: Tensor,
    depths: Tensor,
    mask: Tensor,
    grid: Tuple[int, int],
    max_tiles_per_gaussian: int,
    opacities: Optional[Tensor] = None,
    con_a: Optional[Tensor] = None,
    con_b: Optional[Tensor] = None,
    con_c: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(tile_id, depth, gaussian_idx) for every tile each Gaussian touches,
    slot-major: inputs (..., g) give outputs (..., m*g) ordered (slot,
    gaussian). Invalid slots get tile_id = n_tiles.

    With opacities, Gaussians below 1/255 are culled; with the conic too,
    pairs whose Gaussian cannot reach alpha >= 1/255 anywhere in the tile's
    pixel-center rectangle are culled exactly."""
    gy, gx = grid
    n_tiles = gy * gx
    g = mean_x.shape[-1]
    m = max_tiles_per_gaussian
    x, y, r = mean_x, mean_y, radii

    def tile_coord(v: Tensor, hi: int) -> Tensor:
        return torch.clamp(torch.floor(v / TILE), 0, hi).to(torch.int32)

    tx0, tx1 = tile_coord(x - r, gx - 1), tile_coord(x + r, gx - 1)
    ty0, ty1 = tile_coord(y - r, gy - 1), tile_coord(y + r, gy - 1)
    rw = tx1 - tx0 + 1
    area = rw * (ty1 - ty0 + 1)
    if opacities is not None:
        mask = mask & (opacities >= 1.0 / 255.0)

    def slot(v: Tensor) -> Tensor:  # (..., g) -> (..., 1, g)
        return v[..., None, :]

    offs = torch.arange(m, dtype=torch.int32, device=x.device)[:, None]  # (m, 1)
    tile_x = slot(tx0) + offs % slot(rw)
    tile_y = slot(ty0) + torch.div(offs, slot(rw), rounding_mode="floor")
    tile_id = tile_y * gx + tile_x
    valid = (offs < slot(area)) & slot(mask) & slot(r > 0)

    if con_a is not None and opacities is not None:
        # min over the tile's pixel-center rect of
        # q(d) = 0.5*ca*dx^2 + cb*dx*dy + 0.5*cc*dy^2 (power = -q).
        ca = slot(torch.clamp(con_a, min=1e-12))
        cb = slot(con_b)
        cc = slot(torch.clamp(con_c, min=1e-12))
        dx0 = tile_x.to(x.dtype) * TILE - slot(x)
        dx1 = dx0 + (TILE - 1)
        dy0 = tile_y.to(y.dtype) * TILE - slot(y)
        dy1 = dy0 + (TILE - 1)

        def q(dx, dy):
            return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

        def edge_x(d):  # fixed dx = d, minimize over dy in [dy0, dy1]
            return q(d, torch.clamp(-cb * d / cc, dy0, dy1))

        def edge_y(d):  # fixed dy = d, minimize over dx in [dx0, dx1]
            return q(torch.clamp(-cb * d / ca, dx0, dx1), d)

        min_q = torch.minimum(
            torch.minimum(edge_x(dx0), edge_x(dx1)),
            torch.minimum(edge_y(dy0), edge_y(dy1)),
        )
        inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
        min_q = torch.where(inside, torch.zeros_like(min_q), min_q)
        reachable = min_q <= torch.log(255.0 * slot(torch.clamp(opacities, min=1e-12)))
        valid = valid & reachable

    tile_id = torch.where(valid, tile_id, torch.full_like(tile_id, n_tiles))
    lead = mean_x.shape[:-1]
    pair_tiles = tile_id.reshape(*lead, m * g)
    pair_depths = slot(depths).expand(*lead, m, g).reshape(*lead, m * g)
    gidx = torch.arange(g, dtype=torch.int32, device=x.device)
    pair_gidx = gidx.expand(*lead, m, g).reshape(*lead, m * g)
    return pair_tiles, pair_depths, pair_gidx


def _sort_pairs(pair_tiles: Tensor, pair_depths: Tensor, pair_gidx: Tensor, n_tiles: int):
    """One stable global sort by a packed (tile, depth) key: the tile id in
    the high bits of a u32, the top bits of the positive f32 depth below
    (monotone as unsigned). The key is held in int64 with the u32's value.
    Below MIN_DEPTH_KEY_BITS of depth the key becomes (tile << 32 | full
    depth bits), the exact lexicographic (tile, depth) order.
    Returns (sorted_tiles, sorted_gidx, starts, ends)."""
    tile_bits = max(int(n_tiles + 1).bit_length(), 1)
    depth_bits = pair_depths.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    tiles = pair_tiles.long()
    if 32 - tile_bits >= MIN_DEPTH_KEY_BITS:
        shift = 32 - tile_bits
        key = (tiles << shift) | (depth_bits >> tile_bits)
    else:
        shift = 32
        key = (tiles << 32) | depth_bits
    sorted_key, order = torch.sort(key, stable=True)
    sorted_tiles = sorted_key >> shift
    sorted_gidx = pair_gidx.index_select(0, order)
    tile_ids = torch.arange(n_tiles, dtype=sorted_tiles.dtype, device=key.device)
    starts = torch.searchsorted(sorted_tiles, tile_ids).to(torch.int32)
    ends = torch.searchsorted(sorted_tiles, tile_ids, right=True).to(torch.int32)
    return sorted_tiles.to(torch.int32), sorted_gidx, starts, ends


class CompositeInputs(NamedTuple):
    """What the compositor receives for n fused views."""

    attrs: Tensor  # (pair_slots, 12) f32
    starts: Tensor  # (n*gy*gx,) i32
    counts: Tensor  # (n*gy*gx,) i32, clamped to max_per_tile
    backgrounds: Tensor  # (n, 3) f32
    grid: Tuple[int, int]
    n_views: int
    live_pairs: Tensor  # i32 scalar
    pair_slots: Tensor  # i32 scalar


def composite_inputs(
    cameras: RasterCamera,
    means: Tensor,
    covariances: Optional[Tensor],
    harmonics: Tensor,
    opacities: Tensor,
    image_shape: Tuple[int, int],
    backgrounds: Optional[Tensor] = None,
    *,
    scales: Optional[Tensor] = None,
    rotations: Optional[Tensor] = None,
    max_tiles_per_gaussian: int = 32,
    max_per_tile: int = 4096,
    pair_cap: Optional[int] = None,
) -> CompositeInputs:
    """Project, bin, sort and pack n views (render_many's steps 1-2)."""
    h, w = image_shape
    if h % TILE or w % TILE:
        raise ValueError(f"image shape {image_shape} must be divisible by {TILE}")
    n, g = means.shape[:2]
    gy, gx = h // TILE, w // TILE
    n_tiles = gy * gx
    n_total = n * n_tiles
    if backgrounds is None:
        backgrounds = torch.zeros(n, 3, dtype=means.dtype, device=means.device)

    proj = project_gaussians(cameras, means, covariances, scales=scales, rotations=rotations)
    dirs = means - cameras.cam_pos[:, None, :]
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-8)
    colors = eval_sh(harmonics, dirs)  # (n, g, 3)

    with trace.span("sort"):
        pair_tiles, pair_depths, pair_gidx = _build_pairs(
            proj.mean_x, proj.mean_y, proj.radii, proj.depths, proj.mask, (gy, gx),
            max_tiles_per_gaussian, opacities=opacities,
            con_a=proj.con_a, con_b=proj.con_b, con_c=proj.con_c,
        )
        # View-major pair order; view i's tiles and gaussian ids go global.
        view_ids = torch.arange(n, dtype=torch.int32, device=means.device)[:, None]
        pair_tiles = torch.where(
            pair_tiles >= n_tiles, torch.full_like(pair_tiles, n_total), pair_tiles + view_ids * n_tiles
        ).reshape(-1)
        pair_gidx = (pair_gidx + view_ids * g).reshape(-1)
        _, sorted_gidx, starts, ends = _sort_pairs(
            pair_tiles, pair_depths.reshape(-1), pair_gidx, n_total
        )
        # Invalid slots sort to the end, so the last tile's end is the live count.
        live_pairs = ends[-1]
        if pair_cap is not None and pair_cap < sorted_gidx.shape[0]:
            # Rounded up to the 128-pair window, so a cap sized to the live
            # count never drops a live pair.
            cap = -(-pair_cap // 128) * 128
            sorted_gidx = sorted_gidx[:cap]
            starts = torch.clamp(starts, max=cap)
            ends = torch.clamp(ends, max=cap)
        counts = torch.clamp(ends - starts, max=max_per_tile)

    def flat(x):
        return x.reshape((n * g,) + x.shape[2:])

    with trace.span("pack"):
        attrs = pack_attrs(
            flat(proj.mean_x), flat(proj.mean_y),
            flat(proj.con_a), flat(proj.con_b), flat(proj.con_c),
            flat(opacities), flat(colors), flat(proj.depths), sorted_gidx,
        )
    return CompositeInputs(
        attrs=attrs,
        starts=starts.contiguous(),
        counts=counts.contiguous(),
        backgrounds=backgrounds.float().reshape(n, 3).contiguous(),
        grid=(gy, gx),
        n_views=n,
        live_pairs=live_pairs,
        pair_slots=torch.tensor(sorted_gidx.shape[0], dtype=torch.int32, device=means.device),
    )


def _tiles_to_image(x: Tensor, n: int, gy: int, gx: int) -> Tensor:
    """(n*gy*gx, P, ...) tile-major -> (n, h, w, ...)."""
    tail = x.shape[2:]
    x = x.reshape(n, gy, gx, TILE, TILE, *tail).transpose(2, 3)
    return x.reshape(n, gy * TILE, gx * TILE, *tail)


def render_many(
    cameras: RasterCamera,  # leading dim (n,) on every field
    means: Tensor,  # (n, g, 3)
    covariances: Optional[Tensor],  # (n, g, 3, 3); None with scales/rotations
    harmonics: Tensor,  # (n, g, 3, d_sh)
    opacities: Tensor,  # (n, g)
    image_shape: Tuple[int, int],
    backgrounds: Optional[Tensor] = None,  # (n, 3)
    *,
    scales: Optional[Tensor] = None,  # (n, g, 3)
    rotations: Optional[Tensor] = None,  # (n, g, 4) xyzw
    max_tiles_per_gaussian: int = 32,
    max_per_tile: int = 4096,
    pair_cap: Optional[int] = None,
) -> RenderOutput:
    """Render n views in one fused pipeline (one sort, one compositor call).

    Runs on the tensors' device: CUDA tensors go through the compositor
    kernels (forward and backward), CPU tensors through their plain PyTorch
    versions.
    pair_cap: optional cap on the total sorted pair slots kept for
    compositing, lossless while live pairs <= pair_cap (see RenderOutput).
    Returns RenderOutput with (n, h, w, ...) images."""
    inputs = composite_inputs(
        cameras, means, covariances, harmonics, opacities, image_shape, backgrounds,
        scales=scales, rotations=rotations, max_tiles_per_gaussian=max_tiles_per_gaussian,
        max_per_tile=max_per_tile, pair_cap=pair_cap,
    )
    out = composite_tiles_diff(
        inputs.attrs, inputs.starts, inputs.counts, inputs.backgrounds,
        inputs.grid, max_per_tile, inputs.n_views,
    )
    n = inputs.n_views
    gy, gx = inputs.grid
    return RenderOutput(
        color=_tiles_to_image(out.color, n, gy, gx),
        depth=_tiles_to_image(out.depth, n, gy, gx),
        alpha=_tiles_to_image(out.alpha, n, gy, gx),
        live_pairs=inputs.live_pairs,
        pair_slots=inputs.pair_slots,
    )


def render(
    camera: RasterCamera,
    means: Tensor,
    covariances: Optional[Tensor],
    harmonics: Tensor,
    opacities: Tensor,
    image_shape: Tuple[int, int],
    background: Optional[Tensor] = None,
    *,
    scales: Optional[Tensor] = None,
    rotations: Optional[Tensor] = None,
    max_tiles_per_gaussian: int = 32,
    max_per_tile: int = 4096,
    pair_cap: Optional[int] = None,
) -> RenderOutput:
    """Render one view of one scene: the n = 1 case of render_many, with
    unbatched camera fields and (g, ...) Gaussians."""
    if background is None:
        background = torch.zeros(3, dtype=means.dtype, device=means.device)
    out = render_many(
        RasterCamera(*(torch.as_tensor(x)[None] for x in camera)),
        means[None], None if covariances is None else covariances[None],
        harmonics[None], opacities[None], image_shape, background[None],
        scales=None if scales is None else scales[None],
        rotations=None if rotations is None else rotations[None],
        max_tiles_per_gaussian=max_tiles_per_gaussian,
        max_per_tile=max_per_tile, pair_cap=pair_cap,
    )
    return RenderOutput(
        color=out.color[0], depth=out.depth[0], alpha=out.alpha[0],
        live_pairs=out.live_pairs, pair_slots=out.pair_slots,
    )
